"""Smoke run of the PyTorch port on one CUDA card: build, check, serve, time.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
(the kernels are built for sm_90a) and the CUDA toolkit. Phases, each of
which raises on failure (exit code != 0):

1. device   — the card's name, power limit and TF32 flags;
2. build    — nvcc builds the port's four CUDA kernels from csrc/;
3. kernels  — each kernel vs its plain PyTorch version on the card,
              `torch.equal` required: the NMS sweep at B=128, N=169;
              conv_int8 at every conv_int8 shape of the int8 trunk at 416²
              (b=8, with and without skip, k 1 and 3, stride 1 and 2) plus
              rectangular inputs; block_int8 at the three residual stages
              (b=32) plus a rectangular input. The bf16 fused front
              (fused_front) at 416² b=8 and 100² (ragged tiles) within one
              bf16 step on at most 0.1 % of the elements (FRONT_*). Then
              each is timed with CUDA events at the main path's shapes (one
              416² trunk at b=32 for the int8 kernels, the front at b=32)
              beside its plain version, its bound and a library yardstick:
              one `torch._int_mm` per int8 GEMM (product only: the im2col
              the library would need is not counted), the two cuDNN bf16
              convs for the front (products only), and the port's stock
              depth-0 bf16 front;
4. slice    — f32: the CLI (`api.face_detection.main`, test mode) serves 8
              seeded JPEGs at 416², batch 4, with seeded random weights
              from a .pt checkpoint; then the device letterbox, the card's
              head vs the CPU's, and the kernel postprocess vs the plain one;
5. int8     — FaceDetectorPipeline(precision="int8", int8_pallas_blocks on)
              serves the same JPEGs in test mode from a checkpoint whose
              trainmeta pins int8_tail 3 (seeded random kernels, seeded BN
              statistics); every kernel must launch and the pin must hold.
              Then, at full int8: the trunk with the fused blocks on equals
              the one with them off, and the card's trunk equals the CPU's
              plain one at 416² (an integer program: any difference is a
              kernel fault); the bf16 heads within a stated tolerance;
6. bf16     — FaceDetectorPipeline(precision="bfloat16", bf16_f32_front
              "auto") serves the same JPEGs in test mode (batches of 4: the
              guard probe defers), then the probe runs on 32 letterboxed
              images; then the 416² b=32 detection program through
              apply_graph_folded_front (kernel C, the bf16 trunk from op 2,
              the bf16 head, face_postprocess_batch), whose head must lie
              within 2e-2 of max |head| of the pipeline's depth-0 head;
              fused_front and nms_sweep must launch;
7. timing   — int8 detect_batch img/s at b=32 and b=128 (full int8, blocks
              on), the trunk alone with the blocks on and off, calibration
              seconds, f32 detect_batch at b=8 and b=32, bf16 detect_batch
              at b=32 and b=128 at guard depths 2 and 0, and the bf16
              forward at b=32 with the stock front and with the fused one.

The last lines are the kernels' JSON record, the card's name and power limit
as nvidia-smi reports them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from PIL import Image

SEED = 0
DEVICE = "cuda"
IMAGE_SIZE = 416
F32_TIMING_BATCHES = (8, 32)
INT8_TIMING_BATCHES = (32, 128)
BF16_TIMING_BATCHES = (32, 128)
BF16_DEPTHS = (2, 0)
KERNEL_B, KERNEL_N = 128, 169
CONV_CHECK_B = 8  # conv_int8 vs plain
TRUNK_B = 32  # int8 kernel timings: one trunk at this batch
FRONT_CHECKS = ((8, 416), (3, 100))  # fused_front vs plain: (batch, size)
FRONT_B = 32  # fused_front timing and the bf16 detection program
# Card vs CPU head: cuDNN and the CPU sum each conv in another order, and
# cuDNN may pick Winograd/FFT algorithms for f32, whose rounding differs more.
HEAD_TOL = 1e-4
# The int8 path's bf16 head, card vs CPU, on the same int8 trunk output: the
# two bf16 convs round their f32 sums to bf16 at other places, one bf16 step
# (2^-8 relative) and its effect on the bias add; relative to max |head|.
INT8_HEAD_TOL = 2e-2
# Full int8 (bf16 head) vs the folded f32 program, head NRMSE (the default
# score of models/quant.quantize_autotail) on seeded random weights at 416².
INT8_NRMSE_TOL = 0.1
# fused_front vs its plain twin: both add the bias to an f32 sum taken in
# another order, so a sum next to a bf16 rounding boundary may round the
# other way, in conv_0's output (then carried through conv_1) or in conv_1's:
# max |diff| within one bf16 step at the top of the range (2^-7 of max
# |ref|), on at most 0.1 % of the elements (tests/test_torch_front_fused.py).
FRONT_STEP = 2.0 ** -7
FRONT_MAX_FRACTION = 1e-3
# The fused-front detection head vs the stock depth-0 bf16 head: the two
# fronts round at other places (bias before or after the bf16 rounding), and
# 50 bf16 convs follow; test_torch_folded.py's bf16 bound.
BF16_HEAD_TOL = 2e-2
# Matmul letterbox vs cv2 on the same f32 pixels: f32 rounding only. (cv2 on
# the host path's f64 pixels differs by up to 7e-5 at 1280 wide, in the JAX
# package too: cv2 takes another coefficient path for 64F images.)
LETTERBOX_TOL = 1e-5
# Published dense peaks of one H100 SXM at 700 W and its memory rate.
PEAK_INT8 = 1979e12  # int8 tensor-core operations / s
PEAK_BF16 = 989e12  # bf16 tensor-core operations / s
PEAK_F32 = 67e12  # f32 operations / s outside the tensor cores
HBM = 3.35e12  # bytes / s
# NMS: f32 operations per (live row i, later row j) IoU test in
# csrc/nms_sweep.cu: two overlaps (4 each), the product, area_b (3), the
# union (2), the division and the comparison.
NMS_OPS_PER_PAIR = 16


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> list[float]:
    """Per-call times (ms) of `fn()`, each bracketed by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def quartiles(xs) -> str:
    q1, q2, q3 = np.percentile(xs, [25, 50, 75])
    return f"median {q2:.4f} ms (q1 {q1:.4f}, q3 {q3:.4f}, n={len(xs)})"


def bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """(least time in ms, what bounds it) for moving `nbytes` once and doing
    `ops` at `peak` operations per second."""
    t_bytes, t_ops = nbytes / HBM * 1e3, ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sorted_case(kind: str, b: int, n: int, rng):
    """Descending-sorted (boxes (B,N,4), scores (B,N)) on the card, 20 absent rows."""
    if kind == "degenerate":
        boxes = np.zeros((b, n, 4), np.float32)  # 0/0 IoU everywhere
    else:
        mins = rng.uniform(0, 300, (b, n, 2))
        sizes = rng.uniform(10, 120, (b, n, 2))
        if kind == "integer":  # what the decode gives on the main path
            mins, sizes = np.floor(mins), np.floor(sizes)
        boxes = np.concatenate([mins, mins + sizes], -1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, (b, n)).astype(np.float32)
    for k in range(b):
        scores[k, rng.integers(0, n, 20)] = 0.0
    scores = -np.sort(-scores, axis=-1)
    return torch.from_numpy(boxes).to(DEVICE), torch.from_numpy(scores).to(DEVICE)


def ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


def imread(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def write_images(path: str, rng) -> list[str]:
    """8 seeded noise JPEGs, landscape and portrait, of mixed sizes."""
    dims = [(480, 640), (640, 480), (360, 640), (720, 1280),
            (500, 375), (416, 416), (600, 800), (1024, 768)]
    files = []
    for i, (h, w) in enumerate(dims):
        fn = os.path.join(path, f"img_{i}.jpg")
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(fn)
        files.append(fn)
    return files


def check_csv(csv: str, n_files: int, what: str):
    rows = [line.split(",") for line in open(csv).read().splitlines()]
    per_image = collections.Counter(r[0] for r in rows)
    vals = np.asarray([[float(v) for v in r[1:]] for r in rows])
    if not rows or max(per_image.values()) > 60:
        raise AssertionError(f"{what}: solution_fd.csv rows per image: {per_image}")
    if not np.isfinite(vals).all() or (vals[:, 2:4] < 0).any():
        raise AssertionError(f"{what}: non-finite or negative-size rows")
    return (f"{len(rows)} rows over {len(per_image)} of {n_files} images (max "
            f"{max(per_image.values())} per image)")


# ------------------------------------------------------------------ int8 shapes


def trunk_int8_calls(ops, size: int, fused_blocks: bool):
    """The int8 kernel calls of one trunk forward at size², in order:
    ("conv", h, w, cin, cout, k, stride, skip) and ("block", h, w, c, ch),
    walked the way models/quant.apply_graph_quant walks the graph."""
    from face_vijnana_yolov3_tpu_torch.models import quant

    calls, hw, c, i = [], size, 3, 0
    while i < len(ops):
        op = ops[i]
        if fused_blocks and op[0] == "save" and quant._block_match(ops, i, c):
            calls.append(("block", hw, hw, c, ops[i + 1][2]))
            i += 4
            continue
        if op[0] == "conv":
            _, _, cout, k, stride, _, _ = op
            skip = i + 1 < len(ops) and ops[i + 1][0] == "add"
            ho = (hw + 2 * (k // 2) - k) // stride + 1
            calls.append(("conv", hw, hw, c, cout, k, stride, skip))
            hw, c = ho, cout
            i += 2 if skip else 1
            continue
        i += 1
    return calls


def int8_conv_operands(b, h, w, cin, cout, k, stride, skip, rng):
    """Random operands on the card with calibration-like scales: the
    requant lands mostly inside ±127, so rounding decides most outputs."""
    ho = (h + 2 * (k // 2) - k) // stride + 1
    wo = (w + 2 * (k // 2) - k) // stride + 1
    fan_in = k * k * cin
    t = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    args = dict(
        x_q=t(rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)),
        w_q=t(rng.integers(-127, 128, (cout, k, k, cin), dtype=np.int8)),
        w_scale=t((rng.uniform(0.5, 2, cout) / (127 * np.sqrt(fan_in))).astype(np.float32)),
        bias=t(rng.normal(0, 0.2, cout).astype(np.float32)),
        inv_out=t((127 / (60 * rng.uniform(1, 3, cout))).astype(np.float32)),
    )
    if skip:
        args["skip_q"] = t(rng.integers(-127, 128, (b, ho, wo, cout), dtype=np.int8))
        args["skip_s"] = t(rng.uniform(0.1, 0.5, cout).astype(np.float32))
    return args


def int8_block_operands(b, h, w, c, ch, rng):
    t = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    return (t(rng.integers(-127, 128, (b, h, w, c), dtype=np.int8)),
            t(rng.integers(-127, 128, (ch, 1, 1, c), dtype=np.int8)),
            t(rng.integers(-127, 128, (c, 3, 3, ch), dtype=np.int8)),
            t((rng.uniform(0.5, 2, ch) / (127 * np.sqrt(c))).astype(np.float32)),
            t(rng.normal(0, 0.2, ch).astype(np.float32)),
            t((127 / (60 * rng.uniform(1, 3, ch))).astype(np.float32)),
            t((rng.uniform(0.5, 2, c) / (127 * np.sqrt(9 * ch))).astype(np.float32)),
            t(rng.normal(0, 0.2, c).astype(np.float32)),
            t(rng.uniform(0.1, 0.5, c).astype(np.float32)),
            t((127 / (60 * rng.uniform(1, 3, c))).astype(np.float32)))


def conv_cost(b, h, w, cin, cout, k, stride, skip):
    """(bytes, int8 operations) of one conv_int8 call: each input read
    once, the output written once; 2 operations per multiply-add."""
    ho = (h + 2 * (k // 2) - k) // stride + 1
    wo = (w + 2 * (k // 2) - k) // stride + 1
    out = b * ho * wo * cout
    nbytes = b * h * w * cin + cout * k * k * cin + 12 * cout + out * (2 if skip else 1)
    nbytes += 4 * cout if skip else 0
    return nbytes, 2 * out * k * k * cin


def block_cost(b, h, w, c, ch):
    nbytes = 2 * b * h * w * c + 10 * c * ch + 12 * ch + 16 * c
    return nbytes, 2 * b * h * w * (c * ch + 9 * ch * c)


def int_mm_ms(gemms, rng, reps: int = 10) -> float:
    """Median ms of one torch._int_mm per (M, K, N) GEMM, summed: the
    library's int8 product with the operands already laid out (A row-major,
    B the weights (N, K) transposed); K is padded to a multiple of 8 where
    cuBLASLt needs it (conv_0's K = 27 → 32)."""
    total = 0.0
    for m, k, n in gemms:
        k = -(-k // 8) * 8
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(DEVICE)
        w = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)).to(DEVICE)
        total += float(np.median(cuda_ms(lambda: torch._int_mm(a, w.t()), reps)))
        del a, w
    return total


# ------------------------------------------------------------------ phases


def check_int8_kernels(ops, rng) -> dict:
    """conv_int8 and block_int8 vs their plain versions on the card →
    {name: max |kernel - plain|} in int8 steps."""
    from face_vijnana_yolov3_tpu_torch.ops.block_int8 import (
        block_int8,
        block_int8_reference,
    )
    from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import (
        conv_int8,
        conv_int8_reference,
    )

    err = {"conv_int8": 0, "block_int8": 0}
    on = trunk_int8_calls(ops, IMAGE_SIZE, True)
    off = trunk_int8_calls(ops, IMAGE_SIZE, False)
    conv_shapes = sorted({c[1:] for c in on + off if c[0] == "conv"},
                         key=lambda s: (-s[0], s[2], s[3]))
    conv_shapes += [(37, 53, 64, 128, 3, 2, False), (23, 41, 32, 64, 3, 1, True),
                    (19, 11, 256, 128, 1, 1, False)]
    for shape in conv_shapes:
        a = int8_conv_operands(CONV_CHECK_B, *shape, rng)
        kw = {k: a[k] for k in ("skip_q", "skip_s") if k in a}
        got = conv_int8(a["x_q"], a["w_q"], a["w_scale"], a["bias"], a["inv_out"],
                        stride=shape[5], leaky=True, **kw)
        want = conv_int8_reference(a["x_q"], a["w_q"], a["w_scale"], a["bias"],
                                   a["inv_out"], stride=shape[5], leaky=True, **kw)
        torch.cuda.synchronize()
        err["conv_int8"] = max(err["conv_int8"], int((got.int() - want.int()).abs().max()))
        live = float(((want != 0) & (want.abs() < 127)).float().mean())
        print(f"[kernels] conv_int8 b={CONV_CHECK_B} (h, w, cin, cout, k, stride, "
              f"skip)={shape}: torch.equal {torch.equal(got, want)}; {live:.1%} of "
              f"outputs inside (0, 127)")
        if not torch.equal(got, want):
            raise AssertionError(f"conv_int8 != plain version at {shape}")
    block_shapes = sorted({c[1:] for c in on if c[0] == "block"}, reverse=True)
    for b, shape in [(TRUNK_B, s) for s in block_shapes] + [(3, (11, 19, 256, 128))]:
        args = int8_block_operands(b, *shape, rng)
        got = block_int8(*args)
        want = block_int8_reference(*args)
        torch.cuda.synchronize()
        err["block_int8"] = max(err["block_int8"], int((got.int() - want.int()).abs().max()))
        live = float(((want != 0) & (want.abs() < 127)).float().mean())
        print(f"[kernels] block_int8 b={b} (h, w, c, ch)={shape}: torch.equal "
              f"{torch.equal(got, want)}; {live:.1%} of outputs inside (0, 127)")
        if not torch.equal(got, want):
            raise AssertionError(f"block_int8 != plain version at {shape}")
    return err


def time_int8_kernels(ops, card, rng) -> dict:
    """ms, plain ms, bound and _int_mm yardstick of each int8 kernel over the
    calls of one full-int8 trunk at TRUNK_B with the fused blocks on."""
    from face_vijnana_yolov3_tpu_torch.ops.block_int8 import (
        block_int8,
        block_int8_reference,
    )
    from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import (
        conv_int8,
        conv_int8_reference,
    )

    calls = collections.Counter(trunk_int8_calls(ops, IMAGE_SIZE, True))
    rec = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                      t_bytes=0.0, t_ops=0.0) for name in ("conv_int8", "block_int8")}
    b = TRUNK_B
    for call, count in sorted(calls.items(), key=lambda kv: kv[0][0]):
        if call[0] == "conv":
            shape = call[1:]
            h, w, cin, cout, k, stride, skip = shape
            a = int8_conv_operands(b, *shape, rng)
            kw = {key: a[key] for key in ("skip_q", "skip_s") if key in a}
            fn = lambda: conv_int8(a["x_q"], a["w_q"], a["w_scale"], a["bias"],  # noqa: E731
                                   a["inv_out"], stride=stride, leaky=True, **kw)
            plain = lambda: conv_int8_reference(  # noqa: E731
                a["x_q"], a["w_q"], a["w_scale"], a["bias"], a["inv_out"],
                stride=stride, leaky=True, **kw)
            nbytes, n_ops = conv_cost(b, *shape)
            ho = (h + 2 * (k // 2) - k) // stride + 1
            wo = (w + 2 * (k // 2) - k) // stride + 1
            gemms = [(b * ho * wo, k * k * cin, cout)]
            name = "conv_int8"
        else:
            shape = call[1:]
            h, w, c, ch = shape
            args = int8_block_operands(b, *shape, rng)
            fn = lambda: block_int8(*args)  # noqa: E731
            plain = lambda: block_int8_reference(*args)  # noqa: E731
            nbytes, n_ops = block_cost(b, *shape)
            gemms = [(b * h * w, c, ch), (b * h * w, 9 * ch, c)]
            name = "block_int8"
        k_ms = cuda_ms(fn, 20)
        p_ms = cuda_ms(plain, 2, warmup=1)
        lib_ms = int_mm_ms(gemms, rng)
        b_ms, _ = bound(nbytes, n_ops, PEAK_INT8)
        r = rec[name]
        r["ms"] += count * float(np.median(k_ms))
        r["plain_ms"] += count * float(np.median(p_ms))
        r["library_ms"] += count * lib_ms
        r["bound_ms"] += count * b_ms
        r["t_bytes"] += count * nbytes / HBM * 1e3
        r["t_ops"] += count * n_ops / PEAK_INT8 * 1e3
        print(f"[kernels] {name} b={b} {shape} x{count} per trunk on {card}: kernel "
              f"{quartiles(k_ms)}, {n_ops / (np.median(k_ms) * 1e-3) / 1e12:.1f} "
              f"TOP/s; plain {quartiles(p_ms)}; _int_mm product {lib_ms:.4f} ms; "
              f"bound {b_ms:.4f} ms")
        if name == "conv_int8":
            del a
        else:
            del args
    for name, r in rec.items():
        r["bound_by"] = "operations" if r.pop("t_ops") >= r.pop("t_bytes") else "bytes"
        print(f"[kernels] {name} over one int8 trunk at b={b} on {card}: {r['ms']:.3f} "
              f"ms (plain {r['plain_ms']:.1f} ms, _int_mm products "
              f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']})")
    return rec


def front_operands(b, size, rng):
    """Letterbox-like f32 input and folded conv_0/conv_1 params on the card,
    at He-like scales (the trunk's first two convs after folding)."""
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(DEVICE)  # noqa: E731
    x = t(rng.uniform(0, 1, (b, size, size, 3)))
    folded = {
        "conv_0": {"kernel": t(rng.normal(0, np.sqrt(2 / 27), (32, 3, 3, 3))),
                   "bias": t(rng.normal(0, 0.1, 32))},
        "conv_1": {"kernel": t(rng.normal(0, np.sqrt(2 / 288), (64, 32, 3, 3))),
                   "bias": t(rng.normal(0, 0.1, 64))},
    }
    return x, folded


def front_diff(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, float]:
    """(max |diff|, max |ref|, fraction of elements that differ)."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), float(want.float().abs().max()), float((d > 0).float().mean())


def check_front(rng) -> float:
    """fused_front vs fused_front_plain on the card → max |diff|."""
    from face_vijnana_yolov3_tpu_torch.ops.front_fused import (
        fused_front,
        fused_front_plain,
    )

    err = 0.0
    for b, size in FRONT_CHECKS:
        x, folded = front_operands(b, size, rng)
        got = fused_front(x, folded)
        want = fused_front_plain(x, folded)
        torch.cuda.synchronize()
        d_max, ref_max, frac = front_diff(got, want)
        err = max(err, d_max)
        print(f"[kernels] fused_front b={b} {size}²: max |diff| {d_max:.4g}, max |ref| "
              f"{ref_max:.4g} (tol {FRONT_STEP * ref_max:.4g}), {frac:.3g} of the "
              f"elements differ (tol {FRONT_MAX_FRACTION}); {tuple(got.shape)} "
              f"{got.dtype}")
        if not (got.shape == want.shape and got.dtype == torch.bfloat16
                and torch.isfinite(got.float()).all() and d_max <= FRONT_STEP * ref_max
                and frac <= FRONT_MAX_FRACTION):
            raise AssertionError(f"fused_front disagrees with its plain version at "
                                 f"b={b} {size}²")
    return err


def time_front(ops, card, rng) -> dict:
    """ms of fused_front at FRONT_B beside its plain twin, its bound, the two
    cuDNN bf16 convs and the port's stock depth-0 bf16 front."""
    import torch.nn.functional as F

    from face_vijnana_yolov3_tpu_torch.models import darknet
    from face_vijnana_yolov3_tpu_torch.ops.front_fused import (
        fused_front,
        fused_front_plain,
    )

    b, s = FRONT_B, IMAGE_SIZE
    x, folded = front_operands(b, s, rng)
    k_ms = cuda_ms(lambda: fused_front(x, folded), 20)
    p_ms = cuda_ms(lambda: fused_front_plain(x, folded), 5, warmup=1)
    stock_ops = ops[:2] + [("output", "t")]
    stock_ms = cuda_ms(lambda: darknet.apply_graph_folded(
        folded, x, stock_ops, compute_dtype=torch.bfloat16), 10)
    xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    k0 = folded["conv_0"]["kernel"].to(torch.bfloat16)
    k1 = folded["conv_1"]["kernel"].to(torch.bfloat16)
    y = F.conv2d(xb, k0, padding=1)

    def cudnn_pair():
        F.conv2d(xb, k0, padding=1)
        F.conv2d(y, k1, stride=2, padding=1)

    lib_ms = cuda_ms(cudnn_pair, 20)
    g = s // 2
    nbytes = b * s * s * 3 * 4 + b * g * g * 64 * 2 + 2 * (32 * 27 + 64 * 288) + 4 * 96
    n_ops = 2 * b * (s * s * 27 * 32 + g * g * 288 * 64)
    b_ms, b_by = bound(nbytes, n_ops, PEAK_BF16)
    rec = dict(ms=float(np.median(k_ms)), plain_ms=float(np.median(p_ms)),
               library_ms=float(np.median(lib_ms)), bound_ms=b_ms, bound_by=b_by)
    print(f"[kernels] fused_front b={b} {s}² on {card}: kernel {quartiles(k_ms)}, "
          f"{n_ops / (rec['ms'] * 1e-3) / 1e12:.1f} TFLOP/s, "
          f"{nbytes / (rec['ms'] * 1e-3) / 1e9:.0f} GB/s; plain {quartiles(p_ms)}; "
          f"two cuDNN bf16 convs (products only) {quartiles(lib_ms)}; the port's stock "
          f"depth-0 bf16 front {quartiles(stock_ms)}; bound {b_ms:.4f} ms by {b_by} "
          f"({nbytes / 1e6:.1f} MB, {n_ops / 1e9:.1f} GFLOP)")
    del x, folded, xb, y
    return rec


def bf16_slice(tmp, files, fdm, card, dev):
    """The bf16 serving path: the pipeline in test mode with the guard on
    "auto", the probe on 32 images, then the 416² b=32 detection program
    through apply_graph_folded_front. Returns (launch counts of this path,
    the pipeline for timing)."""
    from face_vijnana_yolov3_tpu_torch.api.config import load_conf
    from face_vijnana_yolov3_tpu_torch.models.detector import head_conv
    from face_vijnana_yolov3_tpu_torch.ops.front_fused import (
        apply_graph_folded_front,
        fused_front,
    )
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_host
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import nms_sweep
    from face_vijnana_yolov3_tpu_torch.ops.postprocess import face_postprocess_batch

    path = os.path.join(tmp, "conf_bf16.json")
    csv = os.path.join(tmp, "bf16.csv")
    with open(path, "w") as f:
        json.dump({"fd_conf": {
            "mode": "test", "test_path": tmp, "output_file_path": csv,
            "model_loading": True, "model_path": os.path.join(tmp, "fd_int8_tail0.pt"),
            "bf16_f32_front": "auto",
            "hps": {"face_conf_th": 0.05, "batch_size": 4},
            "nn_arch": {"image_size": IMAGE_SIZE},
        }}, f)
    conf = load_conf(path).fd_conf
    lb = np.asarray([letterbox_host(imread(f) / 255, IMAGE_SIZE, "cubic")[0]
                     for f in sorted(files)], np.float32)
    x32 = torch.from_numpy(np.concatenate([lb] * (FRONT_B // len(lb)))).to(dev)

    fused_front.launches = nms_sweep.launches = 0
    fd = fdm.FaceDetectorPipeline(conf, precision="bfloat16")
    fd.test()
    deferred = not hasattr(fd, "bf16_front_chosen")
    summary = check_csv(csv, len(files), "bf16")
    print(f"[bf16] test mode, bf16_f32_front auto, batches of 4: {summary}; the guard "
          f"probe deferred: {deferred} (fewer than 16 images), served depth "
          f"{fd._bf16_front_depth()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    depth, err = fd.autoselect_bf16_front(x32)
    torch.cuda.synchronize()
    print(f"[bf16] autoselect_bf16_front on {FRONT_B} images on {card}: depth {depth}, "
          f"1-boxF1 {err}, pinned {hasattr(fd, 'bf16_front_chosen')}, "
          f"{time.perf_counter() - t0:.2f} s")

    folded = fd._folded_params()
    with torch.inference_mode():
        trunk = apply_graph_folded_front(folded, x32, fd.model.ops)["trunk"]
        head = head_conv(trunk.to(torch.bfloat16), folded["head"], torch.bfloat16)
        cands, counts = face_postprocess_batch(head, fd._pp_cfg)
        ref = fd._bf16_head(x32, 0)
    torch.cuda.synchronize()
    launches = {"fused_front": fused_front.launches, "nms_sweep": nms_sweep.launches}
    h_err = float((head - ref).abs().max())
    h_max = float(ref.abs().max())
    print(f"[bf16] apply_graph_folded_front detection program, b={FRONT_B} "
          f"{IMAGE_SIZE}²: head {tuple(head.shape)} vs the pipeline's depth-0 head "
          f"max |diff| {h_err:.4g}, max |head| {h_max:.4g} (tol {BF16_HEAD_TOL} of max "
          f"|head|); counts {counts.tolist()[:8]}...; launches {launches}")
    if not (torch.isfinite(head).all() and h_err <= BF16_HEAD_TOL * h_max
            and cands.shape[::2] == (FRONT_B, 6) and torch.isfinite(cands).all()):
        raise AssertionError("the fused-front detection program disagrees with the "
                             "stock bf16 one")
    if min(launches.values()) == 0:
        raise AssertionError(f"the bf16 run skipped a kernel: {launches}")
    return launches, fd


def int8_slice(tmp, files, fdm, card, dev):
    """The int8 serving path through its entry point, then the bit-exact
    checks at full int8. Returns (launch counts of the main path, the
    full-int8 pipeline for timing, its calibration seconds)."""
    from face_vijnana_yolov3_tpu_torch.api.config import load_conf
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import save_checkpoint
    from face_vijnana_yolov3_tpu_torch.models import darknet, quant
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
    from face_vijnana_yolov3_tpu_torch.ops.block_int8 import block_int8
    from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import conv_int8
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_host
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import nms_sweep

    model = FaceDetectorModel(image_size=IMAGE_SIZE, device="cpu")
    params, state = model.init_params(SEED)
    darknet.perturb_batchnorm(params, state, model.ops, SEED + 1)
    sd = params_from_jax(params, state)
    confs = {}
    for pin in (3, 0):
        ckpt = os.path.join(tmp, f"fd_int8_tail{pin}.pt")
        save_checkpoint(ckpt, sd, meta={"int8_tail": pin})
        path = os.path.join(tmp, f"conf_int8_tail{pin}.json")
        with open(path, "w") as f:
            json.dump({"fd_conf": {
                "mode": "test", "test_path": tmp,
                "output_file_path": os.path.join(tmp, f"int8_tail{pin}.csv"),
                "model_loading": True, "model_path": ckpt,
                "int8_pallas_blocks": True,
                "hps": {"face_conf_th": 0.05, "batch_size": 4},
                "nn_arch": {"image_size": IMAGE_SIZE},
            }}, f)
        confs[pin] = load_conf(path).fd_conf

    # The main path: test() calibrates on its first batch, then serves.
    conv_int8.launches = block_int8.launches = nms_sweep.launches = 0
    fd = fdm.FaceDetectorPipeline(confs[3], precision="int8")
    fd.test()
    torch.cuda.synchronize()
    launches = {"conv_int8": conv_int8.launches, "block_int8": block_int8.launches,
                "nms_sweep": nms_sweep.launches}
    summary = check_csv(confs[3].output_file_path, len(files), "int8")
    print(f"[int8] test mode, int8_pallas_blocks on, trainmeta pin int8_tail 3: "
          f"{summary}; launches {launches}; tail chosen {fd.int8_tail_chosen} "
          f"(self-check 1-boxF1 {fd.int8_calib_err:.4f} on the first batch)")
    if min(launches.values()) == 0:
        raise AssertionError(f"the int8 run skipped a kernel: {launches}")
    if fd.int8_tail_chosen != 3 or fd._qparams.get("tail_start") != \
            quant.tail_start_index(fd.model.ops, 3):
        raise AssertionError("the trainmeta pin int8_tail 3 did not hold")

    # Full int8 (pin 0), calibrated on 32 letterboxed images.
    ops = fd.model.ops
    lb = np.asarray([letterbox_host(imread(f) / 255, IMAGE_SIZE, "cubic")[0]
                     for f in sorted(files)], np.float32)
    fd0 = fdm.FaceDetectorPipeline(confs[0], precision="int8")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fd0.calibrate_int8(np.concatenate([lb] * 4))
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    print(f"[int8] calibrate_int8 on 32 images (pin 0: one candidate) on {card}: "
          f"{calib_s:.2f} s; tail {fd0.int8_tail_chosen}, self-check 1-boxF1 "
          f"{fd0.int8_calib_err:.4f}")
    if fd0.int8_tail_chosen != 0 or "tail_start" in fd0._qparams:
        raise AssertionError("pin 0 did not give full int8")
    qp = fd0._qparams
    x2 = torch.from_numpy(lb[:2]).to(dev)
    with torch.inference_mode():
        on = quant.apply_graph_quant(qp, x2, ops, fused_blocks=True)["trunk"]
        off = quant.apply_graph_quant(qp, x2, ops, fused_blocks=False)["trunk"]
    cands_on, counts_on = fd0.detect_batch(lb[:2])
    fd0.conf.int8_pallas_blocks = False
    cands_off, counts_off = fd0.detect_batch(lb[:2])
    fd0.conf.int8_pallas_blocks = True
    torch.cuda.synchronize()
    s_out = torch.from_numpy(qp["act_scales"][-1].astype(np.float32))
    q_on = torch.round(on.cpu() / s_out)
    print(f"[int8] full int8 trunk {tuple(on.shape)}, fused blocks on vs off: "
          f"torch.equal {torch.equal(on, off)}; detect_batch cands equal "
          f"{np.array_equal(cands_on, cands_off)}, counts {counts_on.tolist()}; "
          f"{float(((q_on != 0) & (q_on.abs() < 127)).float().mean()):.1%} of the "
          f"int8 trunk output inside (0, 127)")
    if not (torch.equal(on, off) and np.array_equal(cands_on, cands_off)
            and np.array_equal(counts_on, counts_off)):
        raise AssertionError("the fused blocks change the int8 trunk")

    with torch.inference_mode():
        ref = fd0.model.apply_folded(fd0.model.fold(), x2, compute_dtype=torch.float32)
        head = fd0.model.apply_quant(qp, x2, fused_blocks=True)
    nrmse = float((head - ref).square().mean().sqrt() / ref.square().mean().sqrt())
    print(f"[int8] full int8 head vs the folded f32 head, 2 images: NRMSE {nrmse:.4f} "
          f"(tol {INT8_NRMSE_TOL}); the box-F1 self-check above reads 1.0 on these "
          f"weights because zero-area boxes make its IoU matrix NaN")
    if not nrmse <= INT8_NRMSE_TOL:
        raise AssertionError("the int8 head is far from the f32 one")

    qp_cpu = quant.to_device(qp, "cpu")
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu_trunk = quant.apply_graph_quant(qp_cpu, x2.cpu(), ops, fused_blocks=True)["trunk"]
        head_gpu = fd0.model.apply_quant(qp, x2, fused_blocks=True).cpu()
        head_cpu = fd0.model.apply_quant(qp_cpu, x2.cpu(), fused_blocks=True)
    cpu_s = time.perf_counter() - t0
    head_err = float((head_gpu - head_cpu).abs().max())
    head_max = float(head_cpu.abs().max())
    print(f"[int8] card vs CPU plain versions, full int8 at {IMAGE_SIZE}², 2 images: trunk "
          f"torch.equal {torch.equal(on.cpu(), cpu_trunk)} (CPU {cpu_s:.1f} s); bf16 "
          f"head max |diff| {head_err:.4g}, max |head| {head_max:.4g} (tol "
          f"{INT8_HEAD_TOL} of max |head|)")
    if not torch.equal(on.cpu(), cpu_trunk):
        raise AssertionError("the card's int8 trunk differs from the CPU's")
    if not (np.isfinite(head_gpu.numpy()).all() and head_err <= INT8_HEAD_TOL * head_max):
        raise AssertionError("the card's bf16 head disagrees with the CPU's")
    return launches, fd0, calib_s


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this smoke runs on the card only",
              file=sys.stderr)
        return 2
    from face_vijnana_yolov3_tpu_torch import kernels
    from face_vijnana_yolov3_tpu_torch.api import face_detection as fdm
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import (
        load_checkpoint,
        save_checkpoint,
    )
    from face_vijnana_yolov3_tpu_torch.models import darknet, quant
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel, head_conv
    from face_vijnana_yolov3_tpu_torch.ops.decode import decode_face_head
    from face_vijnana_yolov3_tpu_torch.ops.front_fused import apply_graph_folded_front
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import (
        letterbox_geometry,
        letterbox_host,
    )
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import (
        nms_sweep,
        nms_sweep_reference,
    )
    from face_vijnana_yolov3_tpu_torch.ops.postprocess import (
        face_postprocess_batch,
        select_candidates,
    )
    from face_vijnana_yolov3_tpu_torch.ops.resize import (
        letterbox_device_matmul,
        letterbox_matrices,
    )

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    t_start = time.perf_counter()

    # 1. device
    card = nvidia_smi()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"default TF32 flags: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # 2. build
    path, build_s = kernels.build()
    lib = kernels.load()
    entry_points = [n for n in ("fvy_nms_sweep", "fvy_conv_int8", "fvy_block_int8",
                                "fvy_front_fused") if hasattr(lib, n)]
    print(f"[build] {path.name} built in {build_s:.2f} s; entry points {entry_points}")
    if len(entry_points) != 4:
        raise AssertionError("the library lacks a kernel")

    # 3. kernels vs plain versions, then their times
    max_err = 0.0
    for kind in ("float", "integer", "degenerate"):
        boxes, scores = sorted_case(kind, KERNEL_B, KERNEL_N, rng)
        for th in (0.45, 0.5):
            got = nms_sweep(boxes, scores, th)
            want = nms_sweep_reference(boxes, scores, th)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"nms_sweep != plain version ({kind}, th {th})")
            max_err = max(max_err, float((got - want).abs().max()))
            print(f"[kernels] nms_sweep {kind} th={th}: torch.equal with the plain "
                  f"version; suppressed {int(((want == 0) & (scores > 0)).sum())} "
                  f"of {int((scores > 0).sum())} live rows")
    boxes, scores = sorted_case("integer", KERNEL_B, KERNEL_N, rng)
    k_ms = cuda_ms(lambda: nms_sweep(boxes, scores, 0.5), 50)
    p_ms = cuda_ms(lambda: nms_sweep_reference(boxes, scores, 0.5), 20)
    kept = nms_sweep(boxes, scores, 0.5) > 0
    # IoU tests this input needs: each kept row i against every later row.
    pairs = int((kept * (KERNEL_N - 1 - torch.arange(KERNEL_N, device=dev))).sum())
    nms_bound, nms_bound_by = bound(KERNEL_B * KERNEL_N * (16 + 4 + 4),
                                    NMS_OPS_PER_PAIR * pairs, PEAK_F32)
    print(f"[kernels] nms_sweep B={KERNEL_B} N={KERNEL_N} on {card}: kernel "
          f"{quartiles(k_ms)}; plain {quartiles(p_ms)}; bound {nms_bound * 1e3:.3f} us "
          f"by {nms_bound_by} ({pairs} IoU tests)")
    ops = darknet.trunk_graph()
    int8_err = check_int8_kernels(ops, rng)
    int8_rec = time_int8_kernels(ops, card, rng)
    front_err = check_front(rng)
    front_rec = time_front(ops, card, rng)
    torch.cuda.empty_cache()
    print(f"[kernels] done at {time.perf_counter() - t_start:.0f} s")

    # 4. slice: the CLI in test mode at 416², f32, batch 4
    with tempfile.TemporaryDirectory() as tmp:
        files = write_images(tmp, rng)
        model = FaceDetectorModel(image_size=IMAGE_SIZE)
        ckpt = os.path.join(tmp, "fd_random.pt")
        save_checkpoint(ckpt, params_from_jax(*model.init_params(SEED)),
                        meta={"seed": SEED})
        conf = os.path.join(tmp, "conf.json")
        csv = os.path.join(tmp, "solution_fd.csv")
        with open(conf, "w") as f:
            json.dump({"fd_conf": {
                "mode": "test", "test_path": tmp, "output_file_path": csv,
                "model_loading": True, "model_path": ckpt,
                "hps": {"face_conf_th": 0.05, "batch_size": 4},
                "nn_arch": {"image_size": IMAGE_SIZE},
            }}, f)
        nms_sweep.launches = 0
        fd = fdm.main([f"--conf={conf}"])
        torch.cuda.synchronize()
        f32_launches = nms_sweep.launches
        summary = check_csv(csv, len(files), "f32")
        print(f"[slice] CLI test mode: {summary}; nms_sweep launches {f32_launches}; "
              f"params on {next(fd.model.parameters()).device}; TF32 flags in "
              f"serving: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
              f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
        if f32_launches == 0:
            raise AssertionError("the CLI run never launched the nms_sweep kernel")
        if next(fd.model.parameters()).device.type != dev.type:
            raise AssertionError("the pipeline's parameters are not on the card")
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on in the f32 serving pipeline")

        # The device letterbox (detect_batch_fused) on the CLI's first batch.
        ims = [imread(f) for f in sorted(files)[:4]]
        geoms = [letterbox_geometry(*im.shape[:2], IMAGE_SIZE) for im in ims]
        max_h = max(im.shape[0] for im in ims)
        max_w = max(im.shape[1] for im in ims)
        staged = np.zeros((4, max_h, max_w, 3), np.uint8)
        for k, im in enumerate(ims):
            staged[k, : im.shape[0], : im.shape[1]] = im
        host_lb = np.asarray([letterbox_host(im / 255, IMAGE_SIZE, "cubic")[0]
                              for im in ims], np.float32)
        cv2_lb32 = np.asarray([letterbox_host((im / 255).astype(np.float32),
                                              IMAGE_SIZE, "cubic")[0] for im in ims])
        mats = [letterbox_matrices(g, max_h, max_w, IMAGE_SIZE) for g in geoms]
        dev_lb = letterbox_device_matmul(
            torch.from_numpy(staged).to(dev).float() * (1.0 / 255.0),
            torch.from_numpy(np.stack([m[0] for m in mats])).to(dev),
            torch.from_numpy(np.stack([m[1] for m in mats])).to(dev),
        ).cpu().numpy()
        lb_err = float(np.abs(dev_lb - cv2_lb32).max())
        f_cands, f_counts = fd.detect_batch_fused(staged, geoms)
        h_cands, h_counts = fd.detect_batch(host_lb)
        print(f"[slice] detect_batch_fused: counts {f_counts.tolist()} (host "
              f"letterbox {h_counts.tolist()}); device vs cv2 letterbox max |diff| "
              f"{lb_err:.3g} (tol {LETTERBOX_TOL})")
        if lb_err > LETTERBOX_TOL or not np.isfinite(f_cands).all():
            raise AssertionError("device letterbox disagrees with cv2")

        # The card's head vs the CPU's on 2 images, same weights.
        x = torch.from_numpy(host_lb[:2])
        with torch.inference_mode():
            head_gpu = fd.model(x.to(dev))
            cpu_model = FaceDetectorModel(image_size=IMAGE_SIZE, device="cpu")
            cpu_model.load_state_dict(load_checkpoint(ckpt))
            head_cpu = cpu_model(x)
        head_err = float((head_gpu.cpu() - head_cpu).abs().max())
        print(f"[slice] head (2, 13, 13, 6) card vs CPU: max |diff| {head_err:.3g}, "
              f"max |head| {float(head_cpu.abs().max()):.3g} (tol {HEAD_TOL})")
        if not torch.allclose(head_gpu.cpu(), head_cpu, rtol=HEAD_TOL, atol=HEAD_TOL):
            raise AssertionError("card head disagrees with the CPU head")

        # Kernel postprocess vs the plain one, on the card's decode of its head.
        with torch.inference_mode():
            head_b = fd.model(torch.from_numpy(host_lb).to(dev))
            cfg = fd._pp_cfg
            dec = decode_face_head(head_b, cfg.image_size, cfg.grid, cfg.conf_th)
            cands_k, counts_k = select_candidates(*dec, cfg)
            cands_p, counts_p = select_candidates(*(t.cpu() for t in dec), cfg)
            cpu_dec = decode_face_head(head_b.cpu(), cfg.image_size, cfg.grid,
                                       cfg.conf_th)
        torch.cuda.synchronize()
        dec_ulp = int(ulp_distance(dec[1].cpu().numpy(), cpu_dec[1].numpy()).max())
        print(f"[slice] postprocess, kernel vs plain sweep on the card's decode: "
              f"counts {counts_k.tolist()} vs {counts_p.tolist()}, cands "
              f"torch.equal {torch.equal(cands_k.cpu(), cands_p)}; (the card's vs "
              f"the CPU's decode of one head: scores up to {dec_ulp} ULP apart, expf)")
        if not (torch.equal(counts_k.cpu(), counts_p)
                and torch.equal(cands_k.cpu(), cands_p)):
            raise AssertionError("kernel postprocess disagrees with the plain one")
        print(f"[slice] done at {time.perf_counter() - t_start:.0f} s")

        # 5. int8: the slice's main path, then the bit-exact checks
        launches, fd8, calib_s = int8_slice(tmp, files, fdm, card, dev)
        print(f"[int8] done at {time.perf_counter() - t_start:.0f} s")

        # 6. bf16: the slice's main path, then the fused-front program
        bf16_launches, fdb = bf16_slice(tmp, files, fdm, card, dev)
        print(f"[bf16] done at {time.perf_counter() - t_start:.0f} s")
        torch.cuda.empty_cache()

    # 7. timing: detect_batch img/s over distinct inputs
    rates = {}
    runs = [("int8", fd8, b, None) for b in INT8_TIMING_BATCHES]
    runs += [("f32", fd, b, None) for b in F32_TIMING_BATCHES]
    runs += [("bf16", fdb, b, d) for d in BF16_DEPTHS for b in BF16_TIMING_BATCHES]
    for label, pipe, b, depth in runs:
        if depth is not None:
            pipe.conf.bf16_f32_front = depth
            label = f"bf16 guard depth {depth}"
        inputs = [rng.uniform(size=(b, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
                  for _ in range(3)]
        next_input = itertools.cycle(inputs).__next__
        ms = cuda_ms(lambda: pipe.detect_batch(next_input()), 8, warmup=2)
        rates[(label, b)] = b / (np.median(ms) / 1e3)
        with torch.inference_mode():
            xd = [torch.from_numpy(a).to(dev) for a in inputs[:2]]
            next_x = itertools.cycle(xd).__next__
            if label == "int8":
                fwd = {blocks: cuda_ms(lambda blocks=blocks: quant.apply_graph_quant(
                    pipe._qparams, next_x(), pipe.model.ops,
                    fused_blocks=blocks), 8, warmup=2) for blocks in (True, False)}
                heads = [pipe.model.apply_quant(pipe._qparams, t, fused_blocks=True)
                         for t in xd]
                fwd_txt = (f"int8 trunk, blocks on {quartiles(fwd[True])}; blocks "
                           f"off {quartiles(fwd[False])}")
            elif depth is not None:
                fwd_ms = cuda_ms(lambda: pipe._bf16_head(next_x(), depth), 8, warmup=2)
                heads = [pipe._bf16_head(t, depth) for t in xd]
                fwd_txt = f"trunk+head {quartiles(fwd_ms)}"
            else:
                fwd_ms = cuda_ms(lambda: pipe.model(next_x()), 8, warmup=2)
                heads = [pipe.model(t) for t in xd]
                fwd_txt = f"trunk+head {quartiles(fwd_ms)}"
            next_head = itertools.cycle(heads).__next__
            pp_ms = cuda_ms(lambda: face_postprocess_batch(next_head(), pipe._pp_cfg), 8)
        print(f"[timing] {label} detect_batch b={b} on {card}: "
              f"{rates[(label, b)]:.1f} img/s; detect_batch {quartiles(ms)}; "
              f"{fwd_txt}; postprocess {quartiles(pp_ms)}")
        del inputs, xd, heads
        torch.cuda.empty_cache()
    with torch.inference_mode():
        xd = [torch.from_numpy(rng.uniform(size=(FRONT_B, IMAGE_SIZE, IMAGE_SIZE, 3))
                               .astype(np.float32)).to(dev) for _ in range(2)]
        next_x = itertools.cycle(xd).__next__
        folded = fdb._folded_params()
        stock_ms = cuda_ms(lambda: fdb._bf16_head(next_x(), 0), 8, warmup=2)
        fused_ms = cuda_ms(lambda: head_conv(apply_graph_folded_front(
            folded, next_x(), fdb.model.ops)["trunk"].to(torch.bfloat16),
            folded["head"], torch.bfloat16), 8, warmup=2)
    print(f"[timing] bf16 trunk+head b={FRONT_B} on {card}: stock front (guard depth "
          f"0) {quartiles(stock_ms)}; fused front (apply_graph_folded_front) "
          f"{quartiles(fused_ms)}")
    del xd
    print(f"[timing] int8 calibration (32 images, one candidate) {calib_s:.2f} s; "
          f"total run {time.perf_counter() - t_start:.0f} s")

    kernel_lines = [{
        "name": "nms_sweep",
        "route": "cuda",
        "source": "face_vijnana_yolov3_tpu_torch/csrc/nms_sweep.cu",
        "replaces": "face_vijnana_yolov3_tpu/ops/pallas_nms.py:35",
        "launches": launches["nms_sweep"],
        "max_abs_err": max_err,
        "ms": float(np.median(k_ms)),
        "plain_ms": float(np.median(p_ms)),
        "bound_ms": nms_bound,
        "bound_by": nms_bound_by,
        "library_ms": None,
    }]
    for name, src, replaces, rec, n, err in (
            ("conv_int8", "face_vijnana_yolov3_tpu_torch/csrc/conv_int8.cu",
             "face_vijnana_yolov3_tpu/models/quant.py:666", int8_rec["conv_int8"],
             launches["conv_int8"], int8_err["conv_int8"]),
            ("block_int8", "face_vijnana_yolov3_tpu_torch/csrc/block_int8.cu",
             "face_vijnana_yolov3_tpu/ops/pallas_block.py:88", int8_rec["block_int8"],
             launches["block_int8"], int8_err["block_int8"]),
            ("fused_front", "face_vijnana_yolov3_tpu_torch/csrc/front_fused.cu",
             "face_vijnana_yolov3_tpu/ops/pallas_front.py:49", front_rec,
             bf16_launches["fused_front"], front_err)):
        kernel_lines.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": n, "max_abs_err": err,
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    print(json.dumps({"kernels": kernel_lines}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
