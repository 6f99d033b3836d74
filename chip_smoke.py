"""Smoke run of the PyTorch port on one CUDA card: build, check, serve, time.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
(the kernels are built for sm_90a) and the CUDA toolkit. Phases, each of
which raises on failure (exit code != 0):

1. device   — the card's name, power limit and TF32 flags;
2. build    — nvcc builds the port's four CUDA kernels from csrc/;
3. kernels  — each kernel vs its plain PyTorch version on the card,
              `torch.equal` required: the NMS sweep at B 1, 32, 128 x N 1,
              31, 32, 33, 169, 1024 (float, integer and degenerate boxes;
              non-finite boxes, absent and tied scores at N=169), and at B
              1, 32 x N 1,025, 1,089, 1,600, 4,096 (every kind; the mask in
              a device-memory workspace);
              conv_int8 at every conv_int8 shape of the int8 trunk at 416²
              (b=8 and b=1, with and without skip, k 1 and 3, stride 1 and
              2), at each (cin, cout, k, stride) on a ragged 11x19 input at
              b=3, plus rectangular inputs; block_int8 at the three residual
              stages (b=32 and b=1) and on 11x19 at b=3. The bf16 fused front
              (fused_front) at 416² b=1, 8, 32, 100² (ragged tiles), 98²
              (the loader without TMA) and b=65,537 at 2² and 4², within
              one bf16 step on at most 0.1 % of the elements (FRONT_*). Then
              each is timed with CUDA events at the main path's shapes (one
              416² trunk at b=32 for the int8 kernels, with the blocks on,
              and conv_int8 again over the 52 convs with them off, each call
              and its `_int_mm` yardstick as device time of a replayed CUDA
              graph; the NMS sweep at B=128 and B=32 (and at N 1,089 and
              1,600, B=32) and the front at b=32
              the same way, with per-call events beside them)
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
              forward at b=32 with the stock front and with the fused one;
8. serve    — f32 test mode at image_size 1,056 (N = 1,089: the NMS mask in
              a device-memory workspace) on the card and on the CPU, CSVs
              compared (SERVE_*);
9. calib    — msegrid calibration and PTQ bias correction at 416² on the
              card vs the CPU port (CALIB_*);
10. train   — one f32 train step at b2 416², card vs CPU port (STEP_*);
              train_detector on a seeded synthetic set (TRAIN_*): f32 b32
              through the CLI's mode=train (TF32 off), bf16 mixed at b32 and
              b128, fake-quant QAT at b32, each loss falling; train_img_s
              and peak memory (f32 b32, bf16 b128) with a profiler split of
              a step; the trained checkpoint served at f32 and int8 (A0, A
              and B must launch), evaluate + the mAP harness (AP printed,
              not gated); which JPEG decoder the device-letterbox path ran.

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
KERNEL_B, KERNEL_N = 128, 169  # nms_sweep timing; also at NMS_TIMING_B2
NMS_TIMING_B2 = 32  # the detect_batch b32 shape
NMS_CHECK_B = (1, 32, 128)  # nms_sweep vs plain: every batch at every N
NMS_CHECK_N = (1, 31, 32, 33, 169, 1024)
CONV_CHECK_B = 8  # conv_int8 vs plain
RAGGED_HW = (11, 19)  # ragged kernel checks at b=3
TRUNK_B = 32  # int8 kernel timings: one trunk at this batch
# fused_front vs plain: (batch, size); 416² at b1 (fewer tiles than SMs), b8
# and b32 (many tiles a persistent block), 100² (ragged tiles), 98² (S % 4
# == 2: the loader without TMA), and a batch above 65,535 at the smallest S
# (2, the loader without TMA) and the smallest TMA one (4)
FRONT_CHECKS = ((1, 416), (8, 416), (32, 416), (3, 100), (2, 98), (65537, 2), (65537, 4))
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
# nms_sweep above the shared-memory bound: N = (image_size / 32)^2 > 1024
# from image_size 1,056 up; checked at every B x N, timed at NMS_TIMING_B2.
NMS_LARGE_N = (1025, 1089, 1600, 4096)
NMS_LARGE_B = (1, 32)
NMS_LARGE_TIMED = (1089, 1600)
# [serve]: f32 test mode at 1,056² on the card and the CPU. Scores: the
# card's head is within HEAD_TOL of the CPU's, and score = sigmoid(h0) *
# sigmoid(h5) moves at most 1/4 per unit of each logit. Boxes: a coordinate
# is an integer pixel of a decoded head, so a head an ULP apart may cross a
# pixel boundary on a few rows.
SERVE_LARGE = 1056
SERVE_SCORE_TOL = 0.5 * HEAD_TOL
SERVE_BOX_EXACT = 0.98
# [calib]: msegrid scales from f32 forwards on two devices (convs summed in
# another order): the calibrations' rtol of tests/test_torch_quant.py. Bias
# correction on the same scales: its means of (f32 - int8) differ by the f32
# convs' rounding, and a requant that such a difference moves by one step
# spreads through the later means: each conv's biases within a tenth of its
# largest correction (H100 at 416², 2 images: 0.043, 1.2e-4 absolute).
CALIB_IMAGES = 2
CALIB_SCALE_RTOL = 1e-4
CALIB_BIAS_FRACTION = 0.1
# [train]: the seeded synthetic set at 416², runs (label, precision,
# fake-quant, batch); b128 is the JAX package's train_img_s batch.
TRAIN_IMAGES, VAL_IMAGES = 128, 32
TRAIN_SOURCE_SIZE = 416  # the synthetic JPEGs' side (disks of radius 24-55)
TRAIN_EPOCHS = 4
TRAIN_LR = 1e-4  # FdHps.lr; 1e-3 overshoots in the first epochs from a random init
TRAIN_RUNS = (("f32", "float32", False, 32), ("bf16", "bfloat16", False, 32),
              ("bf16_b128", "bfloat16", False, 128), ("qat", "float32", True, 32))
TRAIN_TIMING_STEPS = 8
# train_img_s: (label, dtype, batch) in order; a label already timed is
# skipped, so bf16 b64 runs only when b128 does not fit the card.
TRAIN_TIMING_RUNS = (("f32", torch.float32, 32), ("bf16", torch.bfloat16, 128),
                     ("bf16", torch.bfloat16, 64))
# One f32 step, card vs CPU port: tests/test_torch_train.py's full-trunk
# bounds (gradients 5e-3 of their norm, each param 0.1: BN over few
# samples and leaky kinks), loss and BN statistics 1e-4 (cuDNN may pick
# Winograd or FFT algorithms for f32 convs, whose rounding differs more).
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = 5e-3
STEP_PARAM_GRAD_TOL = 0.1
STEP_STATE_TOL = 1e-4
# Published dense peaks of one H100 SXM at 700 W and its memory rate.
PEAK_INT8 = 1979e12  # int8 tensor-core operations / s
PEAK_BF16 = 989e12  # bf16 tensor-core operations / s
PEAK_F32 = 67e12  # f32 operations / s outside the tensor cores
HBM = 3.35e12  # bytes / s
# NMS: f32 operations per (live row i, later row j) IoU test: two overlaps
# (4 each), the product, the union (2), the division and the comparison;
# and per box its area (3), which the pairs share.
NMS_OPS_PER_PAIR = 13
NMS_OPS_PER_BOX = 3


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


def graph_ms(fn, reps: int = 20) -> list[float]:
    """Device ms of one `fn()`: `reps` calls captured in one CUDA graph, the
    graph replayed between CUDA events (5 times), over the count. Host launch
    overhead, which per-call events include, stays out."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = [t / reps for t in cuda_ms(graph.replay, 5, warmup=1)]
    del graph
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
    """Descending-sorted (boxes (B,N,4), scores (B,N)) on the card, 20 absent
    rows; "nonfinite": NaN and infinite coordinates on a few boxes;
    "absent": every score 0; "ties": scores on a 0.1 grid (equal
    scores in adjacent rows)."""
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
    if kind == "nonfinite":  # NaN and infinite coordinates on a few boxes
        flat = boxes.reshape(-1)
        pick = rng.choice(flat.size, max(1, flat.size // 25), replace=False)
        flat[pick] = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32), pick.size)
    if kind == "absent":
        scores[:] = 0.0
    if kind == "ties":
        scores = np.round(scores, 1).astype(np.float32)
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
    """Median device ms (graph_ms) of one torch._int_mm per (M, K, N)
    GEMM, summed: the library's int8 product with the operands already laid out (A row-major,
    B the weights (N, K) transposed); K is padded to a multiple of 8 where
    cuBLASLt needs it (conv_0's K = 27 → 32)."""
    total = 0.0
    for m, k, n in gemms:
        k = -(-k // 8) * 8
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(DEVICE)
        w = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)).to(DEVICE)
        total += float(np.median(graph_ms(lambda: torch._int_mm(a, w.t()), reps)))
        del a, w
    return total


# ------------------------------------------------------------------ phases


def check_int8_kernels(ops, rng) -> dict:
    """conv_int8 and block_int8 vs their plain versions on the card →
    {name: max |kernel - plain|} in int8 steps. Every trunk shape at b=8
    (conv) and b=32 (block), every one again at b=1, and ragged 11x19
    inputs at b=3 (new tile edges on both axes)."""
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
    trunk_convs = sorted({c[1:] for c in on + off if c[0] == "conv"},
                         key=lambda s: (-s[0], s[2], s[3]))
    ragged = sorted({(*RAGGED_HW, *c[2:]) for c in trunk_convs})
    conv_cases = ([(CONV_CHECK_B, s) for s in trunk_convs] + [(1, s) for s in trunk_convs]
                  + [(3, s) for s in ragged]
                  + [(CONV_CHECK_B, s) for s in ((37, 53, 64, 128, 3, 2, False),
                                                 (23, 41, 32, 64, 3, 1, True),
                                                 (19, 11, 256, 128, 1, 1, False))])
    for b, shape in conv_cases:
        a = int8_conv_operands(b, *shape, rng)
        kw = {k: a[k] for k in ("skip_q", "skip_s") if k in a}
        got = conv_int8(a["x_q"], a["w_q"], a["w_scale"], a["bias"], a["inv_out"],
                        stride=shape[5], leaky=True, **kw)
        want = conv_int8_reference(a["x_q"], a["w_q"], a["w_scale"], a["bias"],
                                   a["inv_out"], stride=shape[5], leaky=True, **kw)
        torch.cuda.synchronize()
        err["conv_int8"] = max(err["conv_int8"], int((got.int() - want.int()).abs().max()))
        live = float(((want != 0) & (want.abs() < 127)).float().mean())
        print(f"[kernels] conv_int8 b={b} (h, w, cin, cout, k, stride, skip)={shape}: "
              f"torch.equal {torch.equal(got, want)}; {live:.1%} of outputs inside "
              f"(0, 127)")
        if not torch.equal(got, want):
            raise AssertionError(f"conv_int8 != plain version at b={b} {shape}")
        del a, got, want
    block_shapes = sorted({c[1:] for c in on if c[0] == "block"}, reverse=True)
    block_cases = ([(TRUNK_B, s) for s in block_shapes] + [(1, s) for s in block_shapes]
                   + [(3, (*RAGGED_HW, *s[2:])) for s in block_shapes])
    for b, shape in block_cases:
        args = int8_block_operands(b, *shape, rng)
        got = block_int8(*args)
        want = block_int8_reference(*args)
        torch.cuda.synchronize()
        err["block_int8"] = max(err["block_int8"], int((got.int() - want.int()).abs().max()))
        live = float(((want != 0) & (want.abs() < 127)).float().mean())
        print(f"[kernels] block_int8 b={b} (h, w, c, ch)={shape}: torch.equal "
              f"{torch.equal(got, want)}; {live:.1%} of outputs inside (0, 127)")
        if not torch.equal(got, want):
            raise AssertionError(f"block_int8 != plain version at b={b} {shape}")
        del args, got, want
    return err


def time_int8_kernels(ops, card, rng) -> dict:
    """ms, plain ms, bound and _int_mm yardstick of each int8 kernel summed
    over the calls of one full-int8 trunk at TRUNK_B: with the fused blocks
    on (block_int8 and the 12 convs left to conv_int8), and conv_int8 again
    over the 52 convs of the trunk with the blocks off (the default path)."""
    from face_vijnana_yolov3_tpu_torch.ops.block_int8 import (
        block_int8,
        block_int8_reference,
    )
    from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import (
        conv_int8,
        conv_int8_reference,
    )

    trunks = {"on": collections.Counter(trunk_int8_calls(ops, IMAGE_SIZE, True)),
              "off": collections.Counter(trunk_int8_calls(ops, IMAGE_SIZE, False))}
    b = TRUNK_B
    per_call = {}
    for call in sorted(set(trunks["on"]) | set(trunks["off"]), key=lambda c: (c[0], -c[1])):
        shape = call[1:]
        if call[0] == "conv":
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
            operands = a
        else:
            h, w, c, ch = shape
            args = int8_block_operands(b, *shape, rng)
            fn = lambda: block_int8(*args)  # noqa: E731
            plain = lambda: block_int8_reference(*args)  # noqa: E731
            nbytes, n_ops = block_cost(b, *shape)
            gemms = [(b * h * w, c, ch), (b * h * w, 9 * ch, c)]
            operands = args
        k_ms = float(np.median(graph_ms(fn)))
        call_ms = float(np.median(cuda_ms(fn, 20)))
        p_ms = float(np.median(cuda_ms(plain, 2, warmup=1)))
        lib_ms = int_mm_ms(gemms, rng)
        per_call[call] = dict(ms=k_ms, call_ms=call_ms, plain_ms=p_ms, library_ms=lib_ms,
                              bound_ms=bound(nbytes, n_ops, PEAK_INT8)[0],
                              t_bytes=nbytes / HBM * 1e3, t_ops=n_ops / PEAK_INT8 * 1e3)
        print(f"[kernels] {call[0]} b={b} {shape} x{trunks['on'][call]} per trunk with "
              f"the blocks on, x{trunks['off'][call]} off, on {card}: kernel {k_ms:.4f} "
              f"ms on the device, {n_ops / (k_ms * 1e-3) / 1e12:.1f} TOP/s ({call_ms:.4f} "
              f"ms a call between events, host launch included); plain {p_ms:.4f} ms; "
              f"_int_mm product {lib_ms:.4f} ms; bound {per_call[call]['bound_ms']:.4f} ms")
        del operands, fn, plain
    rec = {}
    for name, kind, trunk in (("conv_int8", "conv", "on"), ("block_int8", "block", "on"),
                              ("conv_int8 blocks off", "conv", "off")):
        r = {key: sum(n * per_call[c][key] for c, n in trunks[trunk].items() if c[0] == kind)
             for key in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "t_bytes",
                         "t_ops")}
        r["bound_by"] = "operations" if r.pop("t_ops") >= r.pop("t_bytes") else "bytes"
        r["calls"] = sum(n for c, n in trunks[trunk].items() if c[0] == kind)
        rec[name] = r
        print(f"[kernels] {name}: {r['calls']} calls of one int8 trunk at b={b} on {card}: "
              f"{r['ms']:.3f} ms on the device ({r['call_ms']:.3f} ms in calls between "
              f"events), plain {r['plain_ms']:.1f} ms, _int_mm products "
              f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
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
    """Device ms (a replayed CUDA graph) of fused_front at FRONT_B beside its
    plain twin, its bound, the two cuDNN bf16 convs and the port's stock
    depth-0 bf16 front, and the kernel's ms a call between CUDA events."""
    import torch.nn.functional as F

    from face_vijnana_yolov3_tpu_torch.models import darknet
    from face_vijnana_yolov3_tpu_torch.ops.front_fused import (
        fused_front,
        fused_front_plain,
    )

    b, s = FRONT_B, IMAGE_SIZE
    x, folded = front_operands(b, s, rng)
    k_ms = graph_ms(lambda: fused_front(x, folded))
    e_ms = cuda_ms(lambda: fused_front(x, folded), 20)
    p_ms = graph_ms(lambda: fused_front_plain(x, folded), reps=5)
    stock_ops = ops[:2] + [("output", "t")]
    stock_ms = graph_ms(lambda: darknet.apply_graph_folded(
        folded, x, stock_ops, compute_dtype=torch.bfloat16), reps=10)
    xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    k0 = folded["conv_0"]["kernel"].to(torch.bfloat16)
    k1 = folded["conv_1"]["kernel"].to(torch.bfloat16)
    y = F.conv2d(xb, k0, padding=1)

    def cudnn_pair():
        F.conv2d(xb, k0, padding=1)
        F.conv2d(y, k1, stride=2, padding=1)

    lib_ms = graph_ms(cudnn_pair)
    g = s // 2
    nbytes = b * s * s * 3 * 4 + b * g * g * 64 * 2 + 2 * (32 * 27 + 64 * 288) + 4 * 96
    n_ops = 2 * b * (s * s * 27 * 32 + g * g * 288 * 64)
    b_ms, b_by = bound(nbytes, n_ops, PEAK_BF16)
    rec = dict(ms=float(np.median(k_ms)), events_ms=float(np.median(e_ms)),
               plain_ms=float(np.median(p_ms)), library_ms=float(np.median(lib_ms)),
               stock_ms=float(np.median(stock_ms)), bound_ms=b_ms, bound_by=b_by)
    print(f"[kernels] fused_front b={b} {s}² on {card}, all on the device (CUDA graph "
          f"replay): kernel {quartiles(k_ms)}, {quartiles(e_ms)} a call between events, "
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


# ------------------------------------------------------------------ new phases


def check_nms_large(card, rng) -> dict:
    """nms_sweep above the shared-memory bound (N > 1024, the mask in a
    device-memory workspace): torch.equal with the plain version at
    NMS_LARGE_B x NMS_LARGE_N x every case kind, then device and per-call
    times at B=NMS_TIMING_B2 for NMS_LARGE_TIMED beside the plain version
    and the bound. Returns {N: record} and the max |diff|."""
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import (
        nms_sweep,
        nms_sweep_reference,
    )

    kinds = ("float", "integer", "degenerate", "nonfinite", "absent", "ties")
    cases = [(kind, b, n) for kind in kinds for b in NMS_LARGE_B for n in NMS_LARGE_N]
    for kind, b, n in cases:
        boxes, scores = sorted_case(kind, b, n, rng)
        got = nms_sweep(boxes, scores, 0.5)
        want = nms_sweep_reference(boxes, scores, 0.5)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"nms_sweep != plain version ({kind}, B={b}, N={n})")
        del boxes, scores, got, want
        torch.cuda.empty_cache()
    print(f"[kernels] nms_sweep at N > 1024 (mask in a device-memory workspace): "
          f"torch.equal with the plain version in all {len(cases)} cases (B "
          f"{NMS_LARGE_B} x N {NMS_LARGE_N} x {'/'.join(kinds)})")
    recs = {}
    b = NMS_TIMING_B2
    for n in NMS_LARGE_TIMED:
        boxes, scores = sorted_case("integer", b, n, rng)
        d_ms = graph_ms(lambda: nms_sweep(boxes, scores, 0.5))
        k_ms = cuda_ms(lambda: nms_sweep(boxes, scores, 0.5), 20)
        p_ms = cuda_ms(lambda: nms_sweep_reference(boxes, scores, 0.5), 3, warmup=1)
        kept = nms_sweep(boxes, scores, 0.5) > 0
        pairs = int((kept * (n - 1 - torch.arange(n, device=boxes.device))).sum())
        b_ms, b_by = bound(b * n * (16 + 4 + 4), NMS_OPS_PER_PAIR * pairs
                           + NMS_OPS_PER_BOX * b * n, PEAK_F32)
        recs[n] = dict(ms=float(np.median(d_ms)), events_ms=float(np.median(k_ms)),
                       plain_ms=float(np.median(p_ms)), bound_ms=b_ms, bound_by=b_by)
        print(f"[kernels] nms_sweep B={b} N={n} (image_size {32 * int(n ** 0.5)}) on "
              f"{card}: kernel {quartiles(d_ms)} on the device, {quartiles(k_ms)} a call "
              f"between events; plain {quartiles(p_ms)}; bound {b_ms * 1e3:.3f} us by "
              f"{b_by} ({pairs} IoU tests); {int(kept.sum())} rows kept")
        del boxes, scores
    return recs


def serve_large(tmp, fdm, card, rng) -> int:
    """f32 test mode at image_size SERVE_LARGE (N = 1,089 > 1,024) on the
    card and on the CPU from one checkpoint: as many rows per image, each
    card row with a CPU row within a pixel and SERVE_SCORE_TOL, the boxes
    equal on SERVE_BOX_EXACT of them. Returns the nms_sweep launches."""
    from face_vijnana_yolov3_tpu_torch.api.config import FdConf
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import save_checkpoint
    from face_vijnana_yolov3_tpu_torch.models import darknet
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import nms_sweep

    d = os.path.join(tmp, "serve_large")
    os.makedirs(d)
    for i, (h, w) in enumerate([(1200, 1600), (1080, 1920), (1400, 1050), (1056, 1056)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(d, f"big_{i}.jpg"))
    # Seeded BN statistics spread the scores, so the 60 rows an image keeps
    # are not decided by ties that an ULP of the head reorders.
    ckpt = os.path.join(tmp, "fd_large.pt")
    model = FaceDetectorModel(image_size=SERVE_LARGE, device="cpu")
    params, state = model.init_params(SEED)
    darknet.perturb_batchnorm(params, state, model.ops, SEED + 1)
    save_checkpoint(ckpt, params_from_jax(params, state))
    out = {}
    for device in ("cuda", "cpu"):
        conf = FdConf(mode="test", test_path=d, model_loading=True, model_path=ckpt,
                      output_file_path=os.path.join(tmp, f"large_{device}.csv"))
        conf.nn_arch.image_size = SERVE_LARGE
        conf.hps.face_conf_th, conf.hps.batch_size = 0.05, 2
        if device == "cuda":  # the path whose kernel launches count
            nms_sweep.launches = 0
        t0 = time.perf_counter()
        fdm.FaceDetectorPipeline(conf, device=device).test()
        torch.cuda.synchronize()
        out[device] = (open(conf.output_file_path).read().splitlines(),
                       time.perf_counter() - t0)
        if device == "cuda":
            launches = nms_sweep.launches
    per_image = {}
    for device, (lines, _) in out.items():
        for line in lines:
            f = line.split(",")
            per_image.setdefault(f[0], {}).setdefault(device, []).append(
                [float(v) for v in f[1:]])
    n_rows = len(out["cpu"][0])
    exact = matched = 0
    worst_px = worst_score = 0.0
    for name, rows in per_image.items():
        card_rows, cpu_rows = rows.get("cuda", []), list(rows.get("cpu", []))
        if len(card_rows) != len(cpu_rows):
            raise AssertionError(f"[serve] {SERVE_LARGE}² {name}: {len(card_rows)} rows "
                                 f"on the card, {len(cpu_rows)} on the CPU")
        for r in card_rows:  # the CPU row closest to each card row
            d = [np.abs(np.asarray(r) - np.asarray(c)) for c in cpu_rows]
            k = int(np.argmin([max(x[:4].max(), x[4] / SERVE_SCORE_TOL) for x in d]))
            if d[k][:4].max() <= 1 and d[k][4] <= SERVE_SCORE_TOL:
                matched += 1
                exact += int((d[k][:4] == 0).all())
                worst_px = max(worst_px, float(d[k][:4].max()))
                worst_score = max(worst_score, float(d[k][4]))
                cpu_rows.pop(k)
    print(f"[serve] f32 test mode at {SERVE_LARGE}² (N = {(SERVE_LARGE // 32) ** 2}), 4 "
          f"JPEGs, batch 2, on {card}: {n_rows} rows on both; {matched} card rows have a "
          f"CPU row within 1 px and {SERVE_SCORE_TOL} (tol: all), {exact} of them with "
          f"the box equal (tol: >= {SERVE_BOX_EXACT:.0%}); worst {worst_px:g} px, "
          f"{worst_score:.3g} in score; nms_sweep launches {launches}; card "
          f"{out['cuda'][1]:.1f} s, CPU {out['cpu'][1]:.1f} s")
    if not (n_rows and matched == n_rows and exact >= SERVE_BOX_EXACT * n_rows
            and launches > 0):
        raise AssertionError(f"[serve] the card's {SERVE_LARGE}² CSV disagrees with the CPU's")
    return launches


def calib_phase(card, dev, rng):
    """int8 calibration on the card vs the CPU port: msegrid scales (rtol
    CALIB_SCALE_RTOL: each position's max comes from f32 forwards whose
    convs sum in another order), then bias correction on the CPU's msegrid
    scales: kernel_q and w_scale bit-identical, biases within
    CALIB_BIAS_FRACTION of each conv's largest correction."""
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
    from face_vijnana_yolov3_tpu_torch.models import darknet, quant
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel

    model = FaceDetectorModel(image_size=IMAGE_SIZE, device="cpu")
    params, state = model.init_params(SEED + 2)
    darknet.perturb_batchnorm(params, state, model.ops, SEED + 3)
    model.load_state_dict(params_from_jax(params, state))
    folded_cpu = model.fold()
    folded_dev = {k: {n: t.to(dev) for n, t in v.items()} for k, v in folded_cpu.items()}
    x = rng.uniform(0, 1, (CALIB_IMAGES, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    ops = model.ops
    t0 = time.perf_counter()
    s_dev = quant.calibrate_folded(folded_dev, torch.from_numpy(x).to(dev), ops,
                                   percentile="msegrid")
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_cpu = quant.calibrate_folded(folded_cpu, torch.from_numpy(x), ops, percentile="msegrid")
    cpu_s = time.perf_counter() - t0
    rel = max(float(np.abs(a / b - 1).max()) for a, b in zip(s_dev, s_cpu))
    same = sum(int((a == b).sum()) for a, b in zip(s_dev, s_cpu))
    total = sum(b.size for b in s_cpu)
    print(f"[calib] msegrid scales, {CALIB_IMAGES} images at {IMAGE_SIZE}², card vs CPU: "
          f"{same} of {total} channels bit-identical, max rel diff {rel:.3g} (tol "
          f"{CALIB_SCALE_RTOL}); card {dev_s:.2f} s on {card}, CPU {cpu_s:.1f} s")
    if rel > CALIB_SCALE_RTOL:
        raise AssertionError("[calib] msegrid scales differ between card and CPU")
    t0 = time.perf_counter()
    q_dev = quant.quantize_folded(folded_dev, torch.from_numpy(x).to(dev), ops,
                                  act_scales=s_cpu, bias_correct=True)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    q_cpu = quant.quantize_folded(folded_cpu, torch.from_numpy(x), ops, act_scales=s_cpu,
                                  bias_correct=True)
    q_plain = quant.quantize_folded(folded_cpu, None, ops, act_scales=s_cpu)
    worst_abs, worst_rel = 0.0, 0.0
    for op in ops:
        if op[0] != "conv":
            continue
        k = f"conv_{op[1]}"
        if not (torch.equal(q_dev[k]["kernel_q"], q_cpu[k]["kernel_q"])
                and torch.equal(q_dev[k]["w_scale"], q_cpu[k]["w_scale"])):
            raise AssertionError(f"[calib] {k}: kernel_q or w_scale differ card vs CPU")
        diff = float((q_dev[k]["bias"] - q_cpu[k]["bias"]).abs().max())
        corr = float((q_cpu[k]["bias"] - q_plain[k]["bias"]).abs().max())
        worst_abs = max(worst_abs, diff)
        worst_rel = max(worst_rel, diff / max(corr, 1e-30))
    print(f"[calib] bias correction on the same scales, card vs CPU: kernel_q and "
          f"w_scale bit-identical; biases max |diff| {worst_abs:.3g}, at most "
          f"{worst_rel:.3g} of the conv's largest correction (tol "
          f"{CALIB_BIAS_FRACTION}); card {dev_s:.2f} s")
    if worst_rel > CALIB_BIAS_FRACTION:
        raise AssertionError("[calib] bias-corrected biases differ between card and CPU")


def profile_split(fn, steps: int) -> dict:
    """Device ms a call of `fn` by kernel family (torch.profiler over
    `steps` calls): convolutions (cuDNN and GEMM kernels), reductions (BN
    statistics and their gradients), the optimizer's foreach kernels, the
    other elementwise passes, and the rest."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    split = collections.Counter()
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if not t or ev.key.startswith(("ProfilerStep", "cuda", "aten::")):
            continue
        name = ev.key.lower()
        if any(s in name for s in ("conv", "cudnn", "xmma", "gemm", "wgrad", "dgrad",
                                   "winograd", "fft", "implicit", "sm90_", "sm80_")):
            split["convs"] += t
        elif "multi_tensor" in name or "foreach" in name:
            split["optimizer"] += t
        elif "reduce" in name:
            split["reductions (BN)"] += t
        elif "elementwise" in name or "vectorized" in name or "unrolled" in name:
            split["elementwise"] += t
        else:
            split["other"] += t
    return {k: v / 1e3 / steps for k, v in split.items()}


def train_phase(tmp, fdm, card, dev):
    """Detector training on the card: one f32 step at b2 vs the CPU port,
    then train_detector on the seeded synthetic set at 416² (f32 through
    the CLI's mode=train, bf16 mixed at two batches, fake-quant QAT),
    train_img_s and peak memory, the trained checkpoint served at f32 and
    int8 (A0, A and B must launch), evaluate + the mAP harness. Returns
    {label: (img/s, batch, peak GB)} and the serving launch counts."""
    from face_vijnana_yolov3_tpu_torch.api.config import FdConf
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import load_train_meta
    from face_vijnana_yolov3_tpu_torch.data import synthetic
    from face_vijnana_yolov3_tpu_torch.data.uccs import DetectionDataset
    from face_vijnana_yolov3_tpu_torch.evals.detection import map_sweep
    from face_vijnana_yolov3_tpu_torch.models import darknet
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
    from face_vijnana_yolov3_tpu_torch.ops.block_int8 import block_int8
    from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import conv_int8
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import nms_sweep
    from face_vijnana_yolov3_tpu_torch.train import optimizer, trainer

    root = synthetic.make_dataset(os.path.join(tmp, "synthetic"), n_train=TRAIN_IMAGES,
                                  n_val=VAL_IMAGES, image_size=TRAIN_SOURCE_SIZE, seed=SEED)
    ds = DetectionDataset(root, image_size=IMAGE_SIZE, grid=IMAGE_SIZE // 32,
                          cache="samples")

    # One f32 step at b2: the card vs the CPU port, same weights and batch.
    model_cpu = FaceDetectorModel(image_size=IMAGE_SIZE, device="cpu")
    sd = params_from_jax(*model_cpu.init_params(SEED + 4))
    model_dev = FaceDetectorModel(image_size=IMAGE_SIZE, device=dev)
    images, gts = ds.batch(0, 2)
    w = np.ones(2, np.float32)
    res = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, model, device in (("card", model_dev, dev), ("cpu", model_cpu, "cpu")):
        p, s = darknet.split_state_dict({k: v.to(device) for k, v in sd.items()})
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        pred, new_state = model.apply_train(leaves, s, torch.from_numpy(images).to(device))
        per = torch.mean(torch.square(pred - torch.from_numpy(gts).to(device)), dim=(1, 2, 3))
        loss = torch.sum(per * torch.from_numpy(w).to(device)) / float(w.sum())
        loss.backward()
        opt = optimizer.KerasAdam(TRAIN_LR)
        upd, _ = opt.update({k: v.grad for k, v in leaves.items()}, opt.init(p))
        res[name] = dict(loss=float(loss.detach()),
                         grads={k: v.grad.detach().cpu() for k, v in leaves.items()},
                         state={k: v.cpu() for k, v in new_state.items()},
                         params={k: (p[k] + upd[k]).cpu() for k in p})
    c, h = res["card"], res["cpu"]
    loss_rel = abs(c["loss"] - h["loss"]) / abs(h["loss"])
    g_tot = sum(float(g.norm()) ** 2 for g in h["grads"].values()) ** 0.5
    g_diff = sum(float((c["grads"][k] - g).norm()) ** 2 for k, g in h["grads"].items()) ** 0.5
    g_worst = max(float((c["grads"][k] - g).norm() / g.norm()) for k, g in h["grads"].items())
    s_err = max(float((c["state"][k] - v).abs().max() / v.abs().max())
                for k, v in h["state"].items())
    p_diff = torch.cat([(c["params"][k] - v).abs().flatten() for k, v in h["params"].items()])
    p_max, p_moved = float(p_diff.max()), float((p_diff > 1e-3 * TRAIN_LR).float().mean())
    print(f"[train] one f32 step at b2 {IMAGE_SIZE}², card vs CPU port on {card}: loss "
          f"{c['loss']:.6f} vs {h['loss']:.6f} (rel {loss_rel:.2g}, tol {STEP_LOSS_RTOL}); "
          f"grads {g_diff / g_tot:.2g} of their norm (tol {STEP_GRAD_TOL}), worst param "
          f"{g_worst:.2g} (tol {STEP_PARAM_GRAD_TOL}); BN statistics {s_err:.2g} (tol "
          f"{STEP_STATE_TOL}); updated params max |diff| {p_max:.3g} (tol {2 * TRAIN_LR}), "
          f"{p_moved:.3%} of them beyond {1e-3 * TRAIN_LR:g} (tol 1%)")
    if not (loss_rel <= STEP_LOSS_RTOL and g_diff <= STEP_GRAD_TOL * g_tot
            and g_worst <= STEP_PARAM_GRAD_TOL and s_err <= STEP_STATE_TOL
            and p_max <= 2 * TRAIN_LR and p_moved <= 0.01):
        raise AssertionError("[train] the card's f32 step disagrees with the CPU port's")
    del res, model_cpu, c, h
    torch.cuda.empty_cache()

    # train_detector: f32 through the CLI (mode=train), then bf16 and QAT.
    ckpts = {}
    for label, precision, qat, b in TRAIN_RUNS:
        ckpt = os.path.join(tmp, f"trained_{label}.pt")
        overrides = {"mode": "train", "raw_data_path": root, "model_path": ckpt,
                     "weights_path": "none.weights", "train_qat": qat,
                     "hps": {"batch_size": b, "epochs": TRAIN_EPOCHS, "lr": TRAIN_LR},
                     "nn_arch": {"image_size": IMAGE_SIZE}}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            if precision == "float32" and not qat:
                path = os.path.join(tmp, f"conf_{label}.json")
                with open(path, "w") as f:
                    json.dump({"fd_conf": overrides}, f)
                fdm.main([f"--conf={path}"])
            else:
                conf = FdConf(**{k: v for k, v in overrides.items()
                                 if k not in ("hps", "nn_arch")})
                conf.nn_arch.image_size = IMAGE_SIZE
                for k, v in overrides["hps"].items():
                    setattr(conf.hps, k, v)
                fdm.FaceDetectorPipeline(conf, precision=precision).train()
        except torch.cuda.OutOfMemoryError:
            print(f"[train] {label}: b={b} does not fit in {card} "
                  f"({torch.cuda.max_memory_allocated() / 2**30:.1f} GiB allocated at "
                  f"the failure)")
            torch.cuda.empty_cache()
            continue
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hist = [json.loads(line)["loss"] for line in open(ckpt + "_history.jsonl")]
        steps = len(hist) // TRAIN_EPOCHS
        first, last = np.mean(hist[:steps]), np.mean(hist[-steps:])
        print(f"[train] {label} ({precision}{', fake-quant' if qat else ''}) b={b}, "
              f"{TRAIN_EPOCHS} epochs of {steps} steps on {TRAIN_IMAGES} synthetic "
              f"images, {card}: epoch mean loss {first:.5f} -> {last:.5f}; {wall:.1f} s "
              f"with finalize_bn_stats and the save; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        if not (np.isfinite(hist).all() and last < first):
            raise AssertionError(f"[train] {label}: loss did not fall ({first} -> {last})")
        ckpts[label] = ckpt

    # train_img_s: the train step on device-resident batches, events over
    # TRAIN_TIMING_STEPS steps after two warm-up steps.
    rates = {}
    model = FaceDetectorModel(image_size=IMAGE_SIZE, device=dev)
    for label, dtype, b in TRAIN_TIMING_RUNS:
        if label in rates:
            continue
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        p, s = darknet.split_state_dict({k: v.to(dev) for k, v in sd.items()})
        opt = optimizer.KerasAdam(TRAIN_LR)
        step = trainer.make_train_step(model, opt, compute_dtype=dtype)
        images, gts = ds.batch(0, len(ds))
        reps = -(-b // len(ds))
        xs = torch.from_numpy(np.concatenate([images] * reps)[:b]).to(dev).to(dtype)
        ys = torch.from_numpy(np.concatenate([gts] * reps)[:b]).to(dev)
        ws = torch.ones(b, device=dev)
        carry = [p, s, opt.init(p)]

        def run():
            carry[0], carry[1], carry[2], _ = step(*carry, xs, ys, ws)

        try:
            ms = cuda_ms(run, TRAIN_TIMING_STEPS, warmup=2)
        except torch.cuda.OutOfMemoryError:
            print(f"[train] train step {label} b={b} does not fit in {card}; timing a "
                  f"smaller batch")
            del carry, xs, ys
            continue
        peak = torch.cuda.max_memory_allocated() / 2**30
        split = profile_split(run, 2)
        rates[label] = (b / (np.median(ms) / 1e3), b, peak)
        split_txt = ", ".join(f"{k} {v:.1f}" for k, v in sorted(split.items(),
                                                              key=lambda kv: -kv[1]))
        print(f"[train] train_img_s {label} b={b} at {IMAGE_SIZE}² on {card}: "
              f"{rates[label][0]:.1f} img/s; step {quartiles(ms)}; peak "
              f"{peak:.1f} GiB (max_memory_allocated); device ms a step by kernel "
              f"family: {split_txt} (sum {sum(split.values()):.1f})")
        del carry, xs, ys, step
    torch.cuda.empty_cache()

    # The trained f32 checkpoint (finalize_bn_stats ran, trainmeta saved)
    # served at f32 and int8, then evaluate + the mAP harness.
    ckpt = ckpts["f32"]
    files = [f for f in os.listdir(root) if f.endswith(".jpg")]
    launches = {}
    for precision in ("float32", "int8"):
        conf = FdConf(mode="test", test_path=root, model_loading=True, model_path=ckpt,
                      output_file_path=os.path.join(tmp, f"trained_{precision}.csv"),
                      int8_pallas_blocks=True)
        conf.nn_arch.image_size = IMAGE_SIZE
        conf.hps.batch_size, conf.hps.face_conf_th = 32, 0.05
        conv_int8.launches = block_int8.launches = nms_sweep.launches = 0
        fd = fdm.FaceDetectorPipeline(conf, precision=precision)
        fd.test()
        torch.cuda.synchronize()
        launches[precision] = {"conv_int8": conv_int8.launches,
                               "block_int8": block_int8.launches,
                               "nms_sweep": nms_sweep.launches}
        summary = check_csv(conf.output_file_path, len(files), precision)
        print(f"[train] the trained checkpoint served at {precision} (test mode, "
              f"{len(files)} images): {summary}; launches {launches[precision]}")
        need = (("conv_int8", "block_int8", "nms_sweep") if precision == "int8"
                else ("nms_sweep",))
        if min(launches[precision][k] for k in need) == 0:
            raise AssertionError(f"[train] serving the trained checkpoint at {precision} "
                                 f"skipped a kernel: {launches[precision]}")
    print(f"[train] trainmeta of the trained checkpoint: {load_train_meta(ckpt)}; "
          f"QAT one: {load_train_meta(ckpts['qat'])}")
    conf = FdConf(mode="evaluate", test_path=root, model_loading=True, model_path=ckpt,
                  output_file_path=os.path.join(tmp, "trained_eval.csv"))
    conf.nn_arch.image_size = IMAGE_SIZE
    conf.hps.batch_size, conf.hps.face_conf_th = 32, 0.05
    cwd = os.getcwd()
    os.chdir(tmp)  # evaluate writes ratios.csv to the working directory
    try:
        fdm.FaceDetectorPipeline(conf).evaluate()
    finally:
        os.chdir(cwd)
    val = os.path.join(tmp, "trained_val.csv")
    with open(val, "w") as f:
        f.writelines(r + "\n" for r in open(conf.output_file_path).read().splitlines()
                     if r.startswith("val_"))
    _, _, aps = map_sweep(os.path.join(root, "validation.csv"), val, out_h5=None)
    print(f"[train] evaluate + the mAP harness on the {VAL_IMAGES} held-out images "
          f"(not gated: {TRAIN_EPOCHS} epochs on {TRAIN_IMAGES} synthetic images): AP50 "
          f"{aps[0]:.4f}, AP50:95 {np.mean(aps):.4f}")

    # Which JPEG decoder the device-letterbox path ran.
    os.environ["FVY_DEVICE_LETTERBOX"] = "1"
    try:
        conf = FdConf(mode="test", test_path=root, model_loading=True, model_path=ckpt,
                      output_file_path=os.path.join(tmp, "trained_native.csv"))
        conf.nn_arch.image_size = IMAGE_SIZE
        conf.hps.batch_size, conf.hps.face_conf_th = 32, 0.05
        fd = fdm.FaceDetectorPipeline(conf)
        fd.test()
    finally:
        del os.environ["FVY_DEVICE_LETTERBOX"]
    print(f"[train] JPEG decoder of the device-letterbox path: {fd.jpeg_decoder} "
          f"({check_csv(conf.output_file_path, len(files), 'native')})")
    return rates, launches


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
    fdm.DEBUG = False  # no per-image progress lines from evaluate/test

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
    cases = [(kind, b, n) for kind in ("float", "integer", "degenerate")
             for b in NMS_CHECK_B for n in NMS_CHECK_N]
    cases += [(kind, b, KERNEL_N) for kind in ("nonfinite", "absent", "ties")
              for b in NMS_CHECK_B]
    for kind, b, n in cases:
        boxes, scores = sorted_case(kind, b, n, rng)
        for th in ((0.45, 0.5) if n == KERNEL_N else (0.45,)):
            got = nms_sweep(boxes, scores, th)
            want = nms_sweep_reference(boxes, scores, th)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"nms_sweep != plain version ({kind}, B={b}, N={n}, "
                                     f"th {th})")
            max_err = max(max_err, float((got - want).abs().max()))
            if b == KERNEL_B and n in (KERNEL_N, 1024):
                print(f"[kernels] nms_sweep {kind} B={b} N={n} th={th}: torch.equal with "
                      f"the plain version; suppressed {int(((want == 0) & (scores > 0)).sum())} "
                      f"of {int((scores > 0).sum())} live rows")
    print(f"[kernels] nms_sweep: torch.equal with the plain version in all {len(cases)} "
          f"cases (B {NMS_CHECK_B} x N {NMS_CHECK_N} x float/integer/degenerate; "
          f"non-finite boxes, absent and tied scores at N={KERNEL_N})")
    nms_rec = {}
    for b in (KERNEL_B, NMS_TIMING_B2):
        boxes, scores = sorted_case("integer", b, KERNEL_N, rng)
        d_ms = graph_ms(lambda: nms_sweep(boxes, scores, 0.5))
        k_ms = cuda_ms(lambda: nms_sweep(boxes, scores, 0.5), 50)
        p_ms = cuda_ms(lambda: nms_sweep_reference(boxes, scores, 0.5), 20)
        kept = nms_sweep(boxes, scores, 0.5) > 0
        # IoU tests this input needs: each kept row i against every later row.
        pairs = int((kept * (KERNEL_N - 1 - torch.arange(KERNEL_N, device=dev))).sum())
        nms_bound, nms_bound_by = bound(
            b * KERNEL_N * (16 + 4 + 4),
            NMS_OPS_PER_PAIR * pairs + NMS_OPS_PER_BOX * b * KERNEL_N, PEAK_F32)
        nms_rec[b] = dict(ms=float(np.median(d_ms)), events_ms=float(np.median(k_ms)),
                          plain_ms=float(np.median(p_ms)), bound_ms=nms_bound,
                          bound_by=nms_bound_by)
        print(f"[kernels] nms_sweep B={b} N={KERNEL_N} on {card}: kernel {quartiles(d_ms)} "
              f"on the device, {quartiles(k_ms)} a call between events (host launch "
              f"included); plain {quartiles(p_ms)}; bound {nms_bound * 1e3:.3f} us by "
              f"{nms_bound_by} ({pairs} IoU tests); {int(kept.sum())} rows kept")
    nms_large = check_nms_large(card, rng)
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
          f"done at {time.perf_counter() - t_start:.0f} s")
    del fd, fd8, fdb
    torch.cuda.empty_cache()

    # 8-10. serving above N = 1024, calibration, training
    with tempfile.TemporaryDirectory() as tmp:
        serve_large(tmp, fdm, card, rng)
        print(f"[serve] done at {time.perf_counter() - t_start:.0f} s")
        calib_phase(card, dev, rng)
        print(f"[calib] done at {time.perf_counter() - t_start:.0f} s")
        train_rates, train_launches = train_phase(tmp, fdm, card, dev)
        print(f"[train] done at {time.perf_counter() - t_start:.0f} s; total run "
              f"{time.perf_counter() - t_start:.0f} s")

    nms = nms_rec[KERNEL_B]
    kernel_lines = [{
        "name": "nms_sweep",
        "route": "cuda",
        "source": "face_vijnana_yolov3_tpu_torch/csrc/nms_sweep.cu",
        "replaces": "face_vijnana_yolov3_tpu/ops/pallas_nms.py:35",
        "launches": launches["nms_sweep"],
        "max_abs_err": max_err,
        "ms": nms["ms"],
        "plain_ms": nms["plain_ms"],
        "bound_ms": nms["bound_ms"],
        "bound_by": nms["bound_by"],
        "library_ms": None,
        "events_ms": nms["events_ms"],
        f"ms_b{NMS_TIMING_B2}": nms_rec[NMS_TIMING_B2]["ms"],
        **{f"{key}_n{n}_b{NMS_TIMING_B2}": rec[key] for n, rec in nms_large.items()
           for key in ("ms", "events_ms", "plain_ms", "bound_ms")},
    }]
    off = int8_rec["conv_int8 blocks off"]
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
        if name == "fused_front":
            kernel_lines[-1].update(events_ms=rec["events_ms"], stock_front_ms=rec["stock_ms"])
        if name == "conv_int8":  # the default path: the trunk with the blocks off
            kernel_lines[-1].update(
                ms_blocks_off=off["ms"], plain_ms_blocks_off=off["plain_ms"],
                bound_ms_blocks_off=off["bound_ms"],
                library_ms_blocks_off=off["library_ms"])
    print(json.dumps({"train_img_s": {k: {"img_s": v[0], "batch": v[1], "peak_gib": v[2]}
                                      for k, v in train_rates.items()},
                      "trained_serving_launches": train_launches}))
    print(json.dumps({"kernels": kernel_lines}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
