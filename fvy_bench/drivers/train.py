"""Driver of the detector training cells: the step program `train_detector`
runs (`trainer.program_step` of `make_train_step`: one captured CUDA graph
of forward, backward and Keras Adam, params, BN state and Adam state
donated), under `trainer.deterministic()`, on device-resident batches.

Set-up makes the weights on the card, paints `ring_chunks` distinct
batches of square scenes with their targets (data/uccs.build_gt_tensor's
arithmetic) onto the card, builds the model, the optimizer and the step,
and drives the step through its first `check_steps` steps on distinct
batches (the first captures the program), keeping the start params, the
first moments after step 1 and the params after the last. The window then
runs step after step over the ring, at most two in flight. After it the
plain reference takes the same first steps from the same params and
batches, and the losses, the first gradients and the change of the params
are compared, each leaf by its norm.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from fvy_bench.harness import costs
from fvy_bench.harness.check import verdict, worst_leaf_gap
from fvy_bench.harness.traffic import gt_tensor, make_scenes
from fvy_bench.harness.trace import profiled, reduce_trace
from fvy_bench.harness.weights import detector_state_dict
from fvy_bench.reference.train import train_steps

SPAN_NAMES = ("train_step",)
# Leaves whose reference gradient is below this share of the median leaf's
# move under Adam by round-off alone: they are left out of the comparison.
NEGLIGIBLE_GRAD = 1e-3


def train_flops_per_image(arch: dict) -> float:
    """Forward and backward conv FLOPs of one image: the forward, the
    weight gradient and the input gradient of every conv but the first,
    whose input needs none."""
    first = costs.conv_flops(costs.trunk_convs(arch)[0])
    return 3 * costs.detector_flops_per_image(arch) - first


def batches(ctx) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The ring of (images (B, S, S, 3) f32 in [0, 1], targets, weights)."""
    tp, arch, dev = ctx.traffic, ctx.config, ctx.device
    frames, faces = make_scenes(tp, ctx.seed, dev)
    g = arch["image_size"] // 32
    gts = torch.from_numpy(np.stack([gt_tensor(f, tp["width"], g, arch["head_channels"])
                                     for f in faces]).astype(np.float32)).to(dev)
    images = frames.to(torch.float32) / 255.0
    b = tp["chunk"]
    ones = torch.ones(b, device=dev)
    return [(images[s:s + b].contiguous(), gts[s:s + b].contiguous(), ones)
            for s in range(0, images.shape[0], b)]


def run(ctx) -> dict:
    from face_vijnana_yolov3_tpu_torch.core.programs import ProgramCache
    from face_vijnana_yolov3_tpu_torch.models.darknet import split_state_dict
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
    from face_vijnana_yolov3_tpu_torch.train.optimizer import KerasAdam
    from face_vijnana_yolov3_tpu_torch.train.trainer import (
        deterministic,
        make_train_step,
        program_step,
    )

    arch, cell, dev = ctx.config, ctx.cell, ctx.device
    sd = detector_state_dict(arch, ctx.seed, dev)
    ring = batches(ctx)
    b = ctx.traffic["chunk"]
    model = FaceDetectorModel(image_size=arch["image_size"],
                              out_channels=arch["head_channels"], device=dev)
    model.load_state_dict(sd)
    params, state = split_state_dict({k: v.detach().clone()
                                      for k, v in model.state_dict().items()})
    o = cell["optimizer"]
    opt = KerasAdam(o["lr"], o["beta_1"], o["beta_2"], o["decay"])
    opt_state = opt.init(params)
    n_check = cell["check_steps"]
    with deterministic():
        step = program_step(ProgramCache(dev, train=True),
                            ("detector", str(torch.float32), False),
                            make_train_step(model, opt), 3)
        p0 = {k: v.detach().clone() for k, v in params.items()}
        losses, mu1, p_last = [], None, None
        for i in range(n_check):
            with ctx.spans.span("train_step"):
                params, state, opt_state, loss = step(params, state, opt_state, *ring[i])
            losses.append(loss.clone())
            if i == 0:
                mu1 = {k: v.detach().clone() for k, v in opt_state.mu.items()}
        p_last = {k: v.detach().clone() for k, v in params.items()}
        ctx.sync()
        steps, done = 0, None
        with profiled(ctx.trace) as prof:
            with ctx.spans.span("window"):
                t0 = time.perf_counter()
                while True:
                    with ctx.spans.span("train_step"):
                        params, state, opt_state, loss = step(
                            params, state, opt_state, *ring[(n_check + steps) % len(ring)])
                        ev = torch.cuda.Event() if dev.type == "cuda" else None
                        if ev is not None:
                            ev.record()
                        if done is not None:
                            done.synchronize()
                    steps, done = steps + 1, ev
                    if time.perf_counter() - t0 >= ctx.seconds:
                        break
                ctx.sync()
                t1 = time.perf_counter()
        finite = bool(torch.isfinite(loss).item())
    e2e = {"train_img_s": steps * b / (t1 - t0), "setup_s": t0 - ctx.t_start}
    record = {"images": steps * b, "window_s": t1 - t0,
              "train_flops_per_image": train_flops_per_image(arch)}
    tr = reduce_trace(prof, SPAN_NAMES) if prof is not None else None
    peak = ctx.memory_peak()
    prog_losses = [float(x) for x in losses]
    del step, params, state, opt_state, model, loss
    gc.collect()
    ctx.free()
    t_ref = time.perf_counter()
    numbers, info = compare(ctx, p0, ring[:n_check], prog_losses, mu1, p_last)
    info["reference_s"] = time.perf_counter() - t_ref
    ok, checks = verdict(numbers, cell["limits"])
    return dict(e2e=e2e, record=record, trace=tr, correct=ok and finite, checks=checks,
                info=info, attempted=steps, failed=0 if finite else steps,
                memory_peak_bytes=peak)


def compare(ctx, p0, check_batches, losses, mu1, p_last):
    """The compared numbers of a run's first steps against the reference's
    from the same params and batches: the widest relative loss gap, and by
    the worst leaf the gap of the first gradient's norm and of the params'
    change's norm (`check.worst_leaf_gap`)."""
    o = ctx.cell["optimizer"]
    ref_losses, g1, p_ref = train_steps(ctx.config, p0, check_batches, o)
    g_prog = {k: (v / (1.0 - o["beta_1"])).cpu().numpy() for k, v in mu1.items()}
    g_ref = {k: v.cpu().numpy() for k, v in g1.items()}
    norms = {k: float(np.linalg.norm(v)) for k, v in g_ref.items()}
    median = float(np.median(list(norms.values())))
    keep = {k for k, n in norms.items() if n >= NEGLIGIBLE_GRAD * median}
    d_prog = {k: (p_last[k] - p0[k]).cpu().numpy() for k in keep}
    d_ref = {k: (p_ref[k] - p0[k]).cpu().numpy() for k in keep}
    numbers = {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        "grad_gap": worst_leaf_gap(g_prog, g_ref, keep),
        "step_gap": worst_leaf_gap(d_prog, d_ref, keep),
    }
    info = {"losses": losses, "reference_losses": ref_losses,
            "leaves_compared": len(keep), "leaves": len(norms)}
    return numbers, info


def readings(ctx, control: dict) -> dict:
    """The numbers of the reference put in the program's place against the
    reference: at the precision below the cell's ({"tf32": True}, the
    control), or with half of each batch left out and the mean taken over
    the rest ({"half_batch": True}, a fault)."""
    sd = detector_state_dict(ctx.config, ctx.seed, ctx.device)
    ring = batches(ctx)[:ctx.cell["check_steps"]]
    low = ring
    if control.get("half_batch"):
        low = [tuple(t[:t.shape[0] // 2] for t in bt) for bt in ring]
    p0 = {k: v.clone() for k, v in sd.items() if not k.endswith((".mean", ".var"))}
    losses, g1, p_last = train_steps(ctx.config, p0, low, ctx.cell["optimizer"],
                                     tf32=control.get("tf32", False))
    mu1 = {k: (1.0 - ctx.cell["optimizer"]["beta_1"]) * v for k, v in g1.items()}
    return compare(ctx, p0, ring, losses, mu1, p_last)[0]
