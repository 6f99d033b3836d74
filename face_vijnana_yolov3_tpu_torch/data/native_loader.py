"""ctypes bindings for the native batched JPEG loader (native/fvy_loader.cpp).

A copy of face_vijnana_yolov3_tpu/data/native_loader.py (the port imports
nothing of the JAX package; tests/test_torch_native_loader.py holds the two
to the same staged buffers). One change: the library is built into
`build/native_loader/` at the root of the checkout (listed in .gitignore),
not beside the source in `native/`.

Builds the shared library on first use (g++ + system libjpeg) and falls back
cleanly when the toolchain or libjpeg is absent — callers check
`native_available()` and use the PIL path otherwise. This is a host-side
decoder: nothing here touches the card.

The native path decodes a whole batch into the device-letterbox staging buffer
layout directly: (n, max_h, max_w, 3) uint8, images packed top-left — the
format `FaceDetectorPipeline.detect_batch_fused` consumes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "fvy_loader.cpp")
LIBRARY = os.path.join(_ROOT, "build", "native_loader", "libfvy_loader.so")


def _load() -> "ctypes.CDLL | None":
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so, src = LIBRARY, SOURCE
    stale = (os.path.exists(so) and os.path.exists(src)
             and os.path.getmtime(src) > os.path.getmtime(so))
    if not os.path.exists(so) or stale:
        if not os.path.exists(src):
            return None
        os.makedirs(os.path.dirname(so), exist_ok=True)
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", src, "-ljpeg", "-o", so],
                check=True, capture_output=True,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.fvy_jpeg_size.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fvy_jpeg_size.restype = ctypes.c_int
    lib.fvy_decode_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    lib.fvy_decode_jpeg_batch.restype = ctypes.c_int
    lib.fvy_decode_jpeg_batch_scaled.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fvy_decode_jpeg_batch_scaled.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


def jpeg_size(path: str) -> tuple[int, int]:
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.fvy_jpeg_size(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"fvy_jpeg_size({path}) failed with {rc}")
    return h.value, w.value


def decode_batch_staged(
    paths: list[str],
    max_h: int | None = None,
    max_w: int | None = None,
    n_threads: int = 4,
):
    """Decode JPEGs into a (n, max_h, max_w, 3) uint8 staging buffer.

    Returns (staged, dims) where dims is (n, 2) int32 of per-image (h, w);
    a (0, 0) row marks a failed decode. max dims default to the batch maxima
    (one header pass).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    n = len(paths)
    if max_h is None or max_w is None:
        sizes = [jpeg_size(p) for p in paths]
        max_h = max(s[0] for s in sizes)
        max_w = max(s[1] for s in sizes)
    staged = np.zeros((n, max_h, max_w, 3), np.uint8)
    dims = np.zeros((n, 2), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    errs = lib.fvy_decode_jpeg_batch(
        c_paths,
        n,
        staged.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        max_h,
        max_w,
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads,
    )
    if errs:
        bad = [paths[i] for i in range(n) if dims[i, 0] == 0]
        raise IOError(f"native decode failed for {errs} images: {bad[:3]}")
    return staged, dims


# ------------------------------------------------- DCT-domain scaled decode

_TURBO_SCALES = None  # lazily probed: does libjpeg support non-power M/8?


def _supports_fractional_scales() -> bool:
    """True when libjpeg honors M/8 for every M in 1..8 (libjpeg-turbo);
    classic libjpeg rounds up to 1/2/4/8 numerators. Probed once by decoding
    a tiny in-memory fixture at 3/8 and checking the output size."""
    global _TURBO_SCALES
    if _TURBO_SCALES is not None:
        return _TURBO_SCALES
    import tempfile

    from PIL import Image

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "probe.jpg")
        Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(p, quality=80)
        staged = np.zeros((1, 64, 64, 3), np.uint8)
        dims = np.zeros((1, 2), np.int32)
        lib = _load()
        c_paths = (ctypes.c_char_p * 1)(p.encode())
        nums = np.full(1, 3, np.int32)
        lib.fvy_decode_jpeg_batch_scaled(
            c_paths, 1,
            staged.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            64, 64, dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            1, nums.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        _TURBO_SCALES = int(dims[0, 0]) == 24  # ceil(64*3/8)
    return _TURBO_SCALES


def pick_scale_num(src_h: int, src_w: int, target: int) -> int:
    """Smallest supported numerator M (of M/8) whose scaled LONG side still
    covers `target` (the letterbox size) — downscale-only, so the follow-up
    strict resize on device never upsamples."""
    long_side = max(src_h, src_w)
    allowed = range(1, 9) if _supports_fractional_scales() else (1, 2, 4, 8)
    for m in allowed:
        if (long_side * m + 7) // 8 >= target:
            return m
    return 8


def decode_batch_staged_scaled(
    paths: list[str],
    target: int,
    n_threads: int = 4,
):
    """DCT-domain scaled batch decode for the streaming detect pipeline.

    Each image decodes at the smallest M/8 that keeps its long side >= the
    letterbox target, cutting IDCT+color-convert work ~(M/8)^2 — the
    replacement for the reference's full-res host decode+resize loop
    (reference src/space/face_detection.py:656-697). NOT bit-exact vs a
    full-res decode (the resize source pixels differ); gate accordingly.

    Returns (staged, dec_dims, orig_dims): staged is (n, max_h, max_w, 3)
    uint8 sized for the SCALED images; dec_dims the actual decoded sizes the
    resize tables must be built from; orig_dims the full-resolution sizes the
    letterbox geometry (and box un-mapping) must be built from.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    n = len(paths)
    orig = np.array([jpeg_size(p) for p in paths], np.int32)
    nums = np.array(
        [pick_scale_num(int(h), int(w), target) for h, w in orig], np.int32
    )
    # staging bound: turbo honors M exactly; classic libjpeg may round M up
    # to the next power of two, so size for that worst case there
    exact = _supports_fractional_scales()

    def bound(dim, m):
        m_eff = m if (exact or m in (1, 2, 4, 8)) else min(
            p for p in (2, 4, 8) if p >= m
        )
        return (dim * m_eff + 7) // 8

    max_h = int(max(bound(int(h), int(m)) for (h, _w), m in zip(orig, nums)))
    max_w = int(max(bound(int(w), int(m)) for (_h, w), m in zip(orig, nums)))
    staged = np.zeros((n, max_h, max_w, 3), np.uint8)
    dims = np.zeros((n, 2), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    errs = lib.fvy_decode_jpeg_batch_scaled(
        c_paths,
        n,
        staged.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        max_h,
        max_w,
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads,
        nums.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    if errs:
        bad = [paths[i] for i in range(n) if dims[i, 0] == 0]
        raise IOError(f"native scaled decode failed for {errs} images: {bad[:3]}")
    return staged, dims, orig
