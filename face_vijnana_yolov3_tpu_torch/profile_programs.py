"""What the serving programs' batch padding and splitting cost on the card.

    python -m face_vijnana_yolov3_tpu_torch.profile_programs [--precision float32 int8]
        [--roi-counts 5,16,17,33] [--frames 8] [--chunks 24] [--batch 32]
        [--short 1,17] [--reps 10] [--seed 0] [--exact-keys] [--roi-memory 60]

Times, on seeded random weights and seeded uint8 640x480 frames:

- identify: `FaceIdentifierPipeline._identify_chunk_device` (the device-ROI
  identify chunk) at each of --roi-counts crops over --frames frames: the
  first call (a capture where the tree captures programs) and the median of
  --reps calls; then --chunks chunks whose crop counts are drawn from a
  seeded Poisson(2) per frame, on a fresh pipeline: the whole sequence's
  first pass (captures included) and second pass; with --roi-memory N, a
  fresh pipeline's first call at N crops of 300-400 px a side (windows of
  512) and `torch.cuda.max_memory_allocated` over it, above what was
  allocated before;
- detect: int8 (blocks on) `detect_batch_fused` at --batch frames, then a
  short last chunk of each of --short frames: its first call and the
  median, padded to --batch where the tree's `detect_batch_fused` takes
  `pad_batch_to`, and in that tree also at its exact size; then a test
  set of three full chunks and a 1-frame chunk on a fresh pipeline, first
  and second pass; a full chunk under FVY_STAGE_BUCKET 128 and 16; and a
  full chunk of frames of two sizes (640x480 and 608x456 staged in one
  buffer: one letterbox matrix pair per frame, as chip_smoke.py phase 15).

--exact-keys replaces `face_identification._bucket_split` by one piece of
the whole count, so every crop count captures (or, in a tree without
programs, runs) its own program: the exact-count keys that the identifier
does not serve, timed for comparison.

It uses only calls that the port had before it served through captured
programs, so that the same script times an older checkout (put that
checkout first on PYTHONPATH). Every time is host wall ms around a call
that returns host data. Prints the card's name and power limit, one line a
case and one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

FRAME = (480, 640)
IMAGE_SIZE = 416
DEVICE = "cuda"


def wall_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def first_and_median(fn, reps: int) -> dict:
    first = wall_ms(fn)
    times = [wall_ms(fn) for _ in range(reps)]
    return {"first_ms": first, "median_ms": float(np.median(times)),
            "q1_ms": float(np.percentile(times, 25)), "q3_ms": float(np.percentile(times, 75))}


def boxes_for(rng, counts):
    """One (n, 5) box array per frame, every crop inside the frame and
    40-200 px a side (none is empty)."""
    h, w = FRAME
    out = []
    for n in counts:
        x0, y0 = rng.uniform(0, w - 220, n), rng.uniform(0, h - 220, n)
        out.append(np.stack([x0, y0, x0 + rng.uniform(40, 200, n),
                             y0 + rng.uniform(40, 200, n), rng.uniform(0.05, 1, n)], axis=1))
    return out


def spread(n: int, frames: int) -> list[int]:
    return [n // frames + (j < n % frames) for j in range(frames)]


def n_programs(pipe) -> int | None:
    return len(pipe.programs) if hasattr(pipe, "programs") else None


def identify(args, precision: str, frames: list, rng) -> dict:
    from face_vijnana_yolov3_tpu_torch.api import face_identification as fim
    from face_vijnana_yolov3_tpu_torch.api.config import Conf
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_host

    fim.DEBUG = False
    if args.exact_keys and hasattr(fim, "_bucket_split"):
        fim._bucket_split = lambda n: [n]

    def pipeline():
        conf = Conf()
        conf.fi_conf.nn_arch.image_size = IMAGE_SIZE
        conf.fi_conf.hps.sim_th = 1e9
        conf.fd_conf.nn_arch.image_size = IMAGE_SIZE
        return fim.FaceIdentifierPipeline(conf, precision=precision, device=DEVICE)

    fi = pipeline()
    reg = fi.embed(np.asarray([letterbox_host(im[:160, :160] / 255, IMAGE_SIZE, "cubic")[0]
                               for im in frames[:8]], np.float32))
    ids = [f"s{k}" for k in range(len(reg))]
    reg_dev = torch.from_numpy(reg).to(DEVICE)
    images = frames[:args.frames]
    out = {"counts": {}}
    for n in args.roi_counts:
        boxes = boxes_for(rng, spread(n, args.frames))
        rec = first_and_median(
            lambda b=boxes: fi._identify_chunk_device(images, b, ids, reg_dev), args.reps)
        rec["programs"] = n_programs(fi)
        out["counts"][n] = rec
        print(f"[identify] {precision} {n} crops: first {rec['first_ms']:.3f} ms, median "
              f"{rec['median_ms']:.3f} (q1 {rec['q1_ms']:.3f}, q3 {rec['q3_ms']:.3f}); "
              f"programs {rec['programs']}", flush=True)
    del fi
    if args.roi_memory:
        fi = pipeline()
        fi.embed(np.asarray(frames[:1], np.float32)[:, :IMAGE_SIZE, :IMAGE_SIZE] / 255)
        h, w = FRAME
        n = args.roi_memory
        boxes = []
        for c in spread(n, args.frames):
            side = rng.uniform(300, 400, (c, 2))
            x0, y0 = rng.uniform(0, w - side[:, 0]), rng.uniform(0, h - side[:, 1])
            boxes.append(np.stack([x0, y0, x0 + side[:, 0], y0 + side[:, 1],
                                   rng.uniform(0.05, 1, c)], axis=1))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = wall_ms(lambda: fi._identify_chunk_device(images, boxes, ids, reg_dev))
        peak = torch.cuda.max_memory_allocated() - base
        out["roi_memory"] = {"crops": n, "first_ms": ms, "peak_bytes": int(peak),
                             "programs": n_programs(fi)}
        print(f"[identify] {precision} {n} crops of 300-400 px, first call {ms:.1f} ms: "
              f"max_memory_allocated {peak / 2**30:.3f} GiB above the {base / 2**30:.3f} "
              f"GiB held before; programs {n_programs(fi)}", flush=True)
        del fi
        torch.cuda.empty_cache()
    if not args.chunks:
        return out
    fi = pipeline()
    fi.embed(np.asarray(frames[:1], np.float32)[:, :IMAGE_SIZE, :IMAGE_SIZE] / 255)
    seq = [boxes_for(rng, rng.poisson(2, args.frames)) for _ in range(args.chunks)]
    crops = [int(sum(len(b) for b in bx)) for bx in seq]
    passes = [wall_ms(lambda: [fi._identify_chunk_device(images, bx, ids, reg_dev)
                               for bx in seq]) for _ in range(2)]
    out["sequence"] = {"crops": crops, "first_pass_ms": passes[0], "second_pass_ms": passes[1],
                       "programs": n_programs(fi)}
    print(f"[identify] {precision} sequence of {args.chunks} chunks ({sum(crops)} crops, "
          f"{min(crops)}-{max(crops)} a chunk): first pass {passes[0]:.1f} ms, second "
          f"{passes[1]:.1f} ms; programs {n_programs(fi)}", flush=True)
    del fi
    return out


def detect(args, frames: list, rng) -> dict:
    from face_vijnana_yolov3_tpu_torch.api import face_detection as fdm
    from face_vijnana_yolov3_tpu_torch.api.config import FdConf
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_geometry

    fdm.DEBUG = False

    def pipeline():
        conf = FdConf(int8_pallas_blocks=True, int8_tail_auto=False)
        conf.nn_arch.image_size = IMAGE_SIZE
        conf.hps.face_conf_th = 0.05
        fd = fdm.FaceDetectorPipeline(conf, precision="int8", device=DEVICE)
        fd.calibrate_int8(rng.uniform(size=(16, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32))
        return fd

    pads = "pad_batch_to" in inspect.signature(
        fdm.FaceDetectorPipeline.detect_batch_fused).parameters
    b = args.batch
    staged = np.stack(frames[:b])
    geoms = [letterbox_geometry(*FRAME, IMAGE_SIZE)] * b

    def call(n, pad=True):
        kw = {"pad_batch_to": b} if pads and pad else {}
        return fd.detect_batch_fused(staged[:n], geoms[:n], **kw)

    fd = pipeline()
    out = {"pads": pads, "full": first_and_median(lambda: call(b), args.reps), "short": {}}
    print(f"[detect] int8 b{b} full chunk: median {out['full']['median_ms']:.3f} ms",
          flush=True)
    for r in args.short:
        rec = {"padded" if pads else "exact": first_and_median(lambda: call(r), args.reps)}
        if pads:
            rec["exact"] = first_and_median(lambda: call(r, pad=False), args.reps)
        out["short"][r] = rec
        print(f"[detect] int8 short chunk of {r}: " + "; ".join(
            f"{k} first {v['first_ms']:.3f} ms, median {v['median_ms']:.3f} "
            f"(q1 {v['q1_ms']:.3f}, q3 {v['q3_ms']:.3f})" for k, v in rec.items()), flush=True)
    del fd
    fd = pipeline()
    sizes = [b, b, b, 1]
    passes = [wall_ms(lambda: [call(n) for n in sizes]) for _ in range(2)]
    out["test_set"] = {"chunks": sizes, "first_pass_ms": passes[0],
                       "second_pass_ms": passes[1], "programs": n_programs(fd)}
    print(f"[detect] int8 test set of chunks {sizes}: first pass {passes[0]:.1f} ms, "
          f"second {passes[1]:.1f} ms; programs {n_programs(fd)}", flush=True)
    out["stage_bucket"] = {}
    for bucket in ("128", "16"):
        os.environ["FVY_STAGE_BUCKET"] = bucket
        out["stage_bucket"][bucket] = first_and_median(lambda: call(b), args.reps)
        print(f"[detect] int8 b{b} full chunk, FVY_STAGE_BUCKET={bucket}: median "
              f"{out['stage_bucket'][bucket]['median_ms']:.3f} ms", flush=True)
    os.environ.pop("FVY_STAGE_BUCKET")
    small = (456, 608)
    mixed = staged.copy()
    for k in range(1, b, 2):
        mixed[k] = 0
        mixed[k, :small[0], :small[1]] = frames[k][:small[0], :small[1]]
    mixed_geoms = [letterbox_geometry(*(small if k % 2 else FRAME), IMAGE_SIZE)
                   for k in range(b)]
    out["mixed"] = first_and_median(lambda: fd.detect_batch_fused(mixed, mixed_geoms),
                                    args.reps)
    print(f"[detect] int8 b{b} full chunk of 640x480 and 608x456 frames (a matrix pair "
          f"each): median {out['mixed']['median_ms']:.3f} ms (q1 "
          f"{out['mixed']['q1_ms']:.3f}, q3 {out['mixed']['q3_ms']:.3f})", flush=True)
    del fd
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--precision", nargs="+", default=["float32", "int8"],
                    choices=("float32", "bfloat16", "int8"), help="identify precisions")
    ap.add_argument("--roi-counts", default="5,16,17,33")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--chunks", type=int, default=24)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--short", default="1,17")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--exact-keys", action="store_true",
                    help="one identify program per crop count")
    ap.add_argument("--roi-memory", type=int, default=0,
                    help="peak memory of one identify chunk of this many large crops")
    args = ap.parse_args()
    args.roi_counts = [int(v) for v in args.roi_counts.split(",")]
    args.short = [int(v) for v in args.short.split(",")]
    if not torch.cuda.is_available():
        print("profile_programs: needs a CUDA card", file=sys.stderr)
        return 2
    import face_vijnana_yolov3_tpu_torch as pkg

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    print(f"card: {card}; package {os.path.dirname(pkg.__file__)}; exact keys "
          f"{args.exact_keys}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    frames = [rng.integers(0, 256, FRAME + (3,), dtype=np.uint8)
              for _ in range(max(args.batch, args.frames, 8))]
    res = {"card": card, "identify": {p: identify(args, p, frames, rng)
                                      for p in args.precision},
           "detect": detect(args, frames, rng)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
