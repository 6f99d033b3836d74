"""Build and bind the port's hand-written CUDA kernels (`csrc/*.cu`).

On first use, `nvcc` compiles every source under `csrc/` for Hopper
(`sm_90a`), one process per source, all started together, and links the
objects into one shared library with a plain C interface,
`build/torch_kernels/libfvy_torch_kernels_<hash>.so` at the root of the
checkout, which `ctypes` loads. The hash covers the sources, the headers
and the flags, so an edit rebuilds and an unchanged tree reuses the library.
Nothing is downloaded and no prebuilt library is committed.

Flags: `-fmad=false` and no `--use_fast_math`, so kernels keep IEEE
division and uncontracted multiply-adds (the parity contract with the JAX
reference, see csrc/nms_sweep.cu); the int8 epilogues write their fused
multiply-adds explicitly (csrc/int8_mma.cuh). The TMA tensor maps of the
int8 kernels and of the fused front are encoded on the host with
`cuTensorMapEncodeTiled` (csrc/hopper.cuh), which the CUDA
runtime hands over through `cudaGetDriverEntryPointByVersion`, so the link
line needs no `-lcuda`.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfvy_torch_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot "
                           "build the port's CUDA kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with the output of any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> tuple[Path, float]:
    """Compile the library if it is not built yet → (path, seconds spent)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # Build in a private directory, then rename: a concurrent build never
    # loads a half-written library.
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        nvcc = _nvcc()
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for src, obj in zip(_sources(), objs)])
        lib = os.path.join(tmp, out.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, time.perf_counter() - t0


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with every entry point's argtypes declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fvy_nms_sweep.argtypes = [p, p, p, p, i, i, f, p]
    lib.fvy_nms_sweep.restype = i
    # x, wq, w_scale, bias, skip, skip_s, inv_out, out,
    # batch, h, w, cin, cout, k, stride, leaky, tile_w, tile_h, stream
    lib.fvy_conv_int8.argtypes = [p] * 8 + [i] * 10 + [p]
    lib.fvy_conv_int8.restype = i
    # x, w1, w2, ws1, b1, inv_mid, ws2, b2, skip_s, inv_out, out,
    # batch, h, w, c, ch, rows, n_split, stream
    lib.fvy_block_int8.argtypes = [p] * 11 + [i] * 7 + [p]
    lib.fvy_block_int8.restype = i
    # x, w0, b0, w1, b1, out, batch, s, stream
    lib.fvy_front_fused.argtypes = [p] * 6 + [i] * 2 + [p]
    lib.fvy_front_fused.restype = i
    return lib
