"""Where the card's time goes in the PyTorch port's detect_batch.

    python -m face_vijnana_yolov3_tpu_torch.profile_detect [--batch 32] [--iters 6]
        [--precision float32|bfloat16|int8] [--front N] [--no-blocks] [--staged HxW]

Runs `FaceDetectorPipeline.detect_batch` (seeded random weights, 416²; f32
with TF32 off; bf16 with the first N graph segments in f32, N = --front,
default 2; or full int8 calibrated on the first batch, with the fused
residual blocks unless --no-blocks) on distinct random letterboxed batches
under torch.profiler and prints: the kernels by self device time, the device
time per category (the port's own kernels, library convolutions, elementwise
passes, copies, the rest), and the device busy share = device time / wall
time of the profiled window. With --staged HxW it runs `detect_batch_fused`
instead, on distinct seeded uint8 frames of that size (one geometry, the
camera case), letterboxed on the card. Either call replays its captured
program (core/programs.py); the calls that capture stay outside the
profiled window. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def category(name: str) -> str:
    n = name.lower()
    for own in ("block_int8", "conv_int8", "nms_sweep", "front_fused"):
        if own in n:
            return own
    if "conv_tma_kernel" in n or "conv_gather_kernel" in n:  # csrc/conv_int8.cu
        return "conv_int8"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if "conv" in n or "xmma" in n or "gemm" in n or "winograd" in n or "fft" in n:
        return "conv/matmul"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", choices=("float32", "bfloat16", "int8"),
                    default="float32")
    ap.add_argument("--front", type=int, default=2,
                    help="bfloat16: graph segments kept f32 (conf.bf16_f32_front)")
    ap.add_argument("--no-blocks", action="store_true",
                    help="int8: run the residual blocks as two conv_int8 launches")
    ap.add_argument("--staged", default=None, metavar="HxW",
                    help="profile detect_batch_fused on uint8 frames of this size")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_detect: needs a CUDA card", file=sys.stderr)
        return 2
    from face_vijnana_yolov3_tpu_torch.api.config import FdConf
    from face_vijnana_yolov3_tpu_torch.api.face_detection import FaceDetectorPipeline
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_geometry

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    conf = FdConf(weights_path="does_not_exist.weights")
    conf.hps.face_conf_th = 0.05
    conf.int8_pallas_blocks = not args.no_blocks
    conf.int8_tail_auto = False  # int8: full int8, no self-check ladder
    conf.bf16_f32_front = args.front
    fd = FaceDetectorPipeline(conf, precision=args.precision, device="cuda")
    rng = np.random.default_rng(args.seed)
    if args.staged:
        h, w = (int(v) for v in args.staged.split("x"))
        xs = [rng.integers(0, 256, (args.batch, h, w, 3), dtype=np.uint8)
              for _ in range(args.iters)]
        geoms = [letterbox_geometry(h, w, 416)] * args.batch

        def call(x):
            return fd.detect_batch_fused(x, geoms)
    else:
        xs = [rng.uniform(size=(args.batch, 416, 416, 3)).astype(np.float32)
              for _ in range(args.iters)]
        call = fd.detect_batch
    for x in xs[:3]:
        call(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in xs:
            call(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_cat: dict[str, float] = {}
    for e in kernels:
        c = category(e.key)
        by_cat[c] = by_cat.get(c, 0.0) + e.self_device_time_total / 1e3
    print(f"card: {card}; {args.precision}"
          f"{' blocks off' if args.no_blocks else ''}"
          f"{f' f32 front {args.front}' if args.precision == 'bfloat16' else ''}"
          f"{f'; detect_batch_fused on {args.staged} uint8 frames' if args.staged else ''}; "
          f"batch {args.batch} x "
          f"{args.iters} distinct batches")
    for e in kernels[:15]:
        print(f"{e.self_device_time_total / 1e3 / args.iters:9.3f} ms/batch "
              f"{e.count // args.iters:5d} calls/batch  {e.key[:110]}")
    print(json.dumps({
        "card": card, "precision": args.precision,
        "fused_blocks": args.precision == "int8" and not args.no_blocks,
        "bf16_f32_front": args.front if args.precision == "bfloat16" else None,
        "batch": args.batch, "iters": args.iters, "staged": args.staged,
        "wall_ms_per_batch": wall_ms / args.iters,
        "device_ms_per_batch": device_ms / args.iters,
        "device_busy_share": device_ms / wall_ms,
        "img_per_s_profiled": args.batch * args.iters / (wall_ms / 1e3),
        "device_ms_per_batch_by_category": {
            k: v / args.iters for k, v in sorted(by_cat.items())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
