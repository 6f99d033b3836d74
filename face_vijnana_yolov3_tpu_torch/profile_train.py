"""Where the card's time goes in a training step, and what deterministic
algorithms cost there.

    python -m face_vijnana_yolov3_tpu_torch.profile_train [--batch 16]
        [--mode float32|bfloat16|fakequant] [--steps 6]
        [--variants off,cudnn,on,fill]

Replays the detector's training program (train/trainer.program_step over
make_train_step, Keras Adam; seeded random weights at 416², two device-
resident random batches) under each variant of the flags, TF32 off in all:
"off" (cuDNN free to pick its algorithms, no deterministic algorithms),
"cudnn" (cudnn.deterministic only), "on" (train/trainer.deterministic(),
the trainers' flags: also torch.use_deterministic_algorithms, without its
fill of uninitialised memory) and "fill" ("on" with the fill, PyTorch's
default under use_deterministic_algorithms). For each variant, in a
program of its own: ms a step (CUDA events around --steps replays,
twice), whether two runs of 3 replays from the same start end on the same
bits, and, under torch.profiler, the device ms a step by category
(convolutions, fills, reductions, the optimizer, elementwise, copies, the
rest) and the five longest kernels. The last line is one JSON object.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

VARIANTS = ("off", "cudnn", "on", "fill")


def category(name: str) -> str:
    n = name.lower()
    if "fillfunctor" in n or "memset" in n:
        return "fill"
    if "memcpy" in n or "copy" in n:
        return "copy"
    if any(s in n for s in ("conv", "cudnn", "xmma", "gemm", "wgrad", "dgrad", "winograd",
                            "fft", "implicit", "sm90_", "sm80_")):
        return "conv"
    if "multi_tensor" in n or "foreach" in n:
        return "optimizer"
    if "reduce" in n:
        return "reduction"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    return "other"


@contextlib.contextmanager
def flags(variant: str):
    """The flags of one variant (module docstring), restored after."""
    import torch.utils.deterministic as det

    from face_vijnana_yolov3_tpu_torch.train.trainer import deterministic

    if variant in ("on", "fill"):
        with deterministic():
            det.fill_uninitialized_memory = variant == "fill"  # deterministic() restores it
            yield
        return
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
             torch.get_float32_matmul_precision(),
             torch.are_deterministic_algorithms_enabled())
    try:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = variant != "off", False, False
        torch.set_float32_matmul_precision("highest")
        torch.use_deterministic_algorithms(False)
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = saved[:3]
        torch.set_float32_matmul_precision(saved[3])
        torch.use_deterministic_algorithms(saved[4])


def main() -> int:
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
    from face_vijnana_yolov3_tpu_torch.core.programs import ProgramCache
    from face_vijnana_yolov3_tpu_torch.models import darknet
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
    from face_vijnana_yolov3_tpu_torch.train import trainer
    from face_vijnana_yolov3_tpu_torch.train.optimizer import KerasAdam

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--mode", choices=("float32", "bfloat16", "fakequant"), default="float32")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures the card: no CUDA device is visible")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dtype = torch.bfloat16 if args.mode == "bfloat16" else torch.float32
    fq = args.mode == "fakequant"
    model = FaceDetectorModel(image_size=416, device=dev)
    p0, s0 = darknet.split_state_dict(
        {k: v.to(dev) for k, v in params_from_jax(*model.init_params(args.seed)).items()})
    rng = np.random.default_rng(args.seed)
    b = args.batch
    feeds = [(torch.from_numpy(rng.uniform(size=(b, 416, 416, 3)).astype(np.float32))
              .to(dev).to(dtype),
              torch.from_numpy(rng.uniform(size=(b, 13, 13, 6)).astype(np.float32)).to(dev),
              torch.ones(b, device=dev)) for _ in range(2)]
    opt = KerasAdam(1e-4)
    step = trainer.make_train_step(model, opt, compute_dtype=dtype, fakequant=fq)
    carry0 = (p0, s0, opt.init(p0))
    report = {"card": card, "mode": args.mode, "batch": b}
    for variant in args.variants.split(","):
        torch.cuda.empty_cache()
        with flags(variant):
            run = trainer.program_step(ProgramCache(dev, train=True),
                                       ("profile", variant), step, 3)
            carry = list(carry0)

            def advance(i):
                carry[:] = run(*carry, *feeds[i % 2])[:-1]

            ends = []
            for _ in range(2):  # the same 3 steps from the same start, twice
                carry[:] = carry0
                for i in range(3):
                    advance(i)
                ends.append([t.clone() for t in trainer._carry_leaves(carry, carry0)])
            equal = all(torch.equal(x, y) for x, y in zip(*ends))
            del ends
            times = []
            for _ in range(2):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for i in range(args.steps):
                    advance(i)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / args.steps)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(args.steps):
                    advance(i)
                torch.cuda.synchronize()
            split, kernels = collections.Counter(), collections.Counter()
            for ev in prof.key_averages():
                t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
                if not t or ev.key.startswith(("ProfilerStep", "cuda", "aten::")):
                    continue
                split[category(ev.key)] += t / 1e3 / args.steps
                kernels[ev.key[:90]] += t / 1e3 / args.steps
            del run, carry
        rec = {"ms": times, "img_s": b / (float(np.median(times)) / 1e3),
               "repeat_equal": equal, "device_ms": dict(split),
               "top": kernels.most_common(5)}
        report[variant] = rec
        print(f"[profile_train] {args.mode} b={b} at 416², flags {variant!r}, on {card}: "
              f"{rec['img_s']:.1f} img/s ({', '.join(f'{t:.2f}' for t in times)} ms a step); "
              f"two runs of 3 replays equal: {equal}; device ms a step: "
              + ", ".join(f"{k} {v:.2f}" for k, v in split.most_common())
              + f" (sum {sum(split.values()):.2f})", flush=True)
        for name, t in rec["top"]:
            print(f"    {t:8.3f} ms  {name}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
