"""Where the fake-quant walk's f32 convs differ from exact integer sums.

Distillation QAT (models/qat.py) replays each conv of the int8 serving
program as an f32 conv of integer-valued operands. Every partial sum of
such a conv is an integer no larger than B = Σ|x|·|k| over its window, so
a conv that adds the products in f32, in any order, gives the exact sum
wherever B ≤ 2^24; an algorithm that transforms its operands first (cuDNN's
FFT and Winograd) need not. The served program's conv (A0, A) sums in
int32 and rounds once to f32, so the fake-quant forward equals it exactly
where its convs are exact.

This walks `qat.apply_graph_fakequant` once over a batch and holds every
conv's f32 result against the served sum (float64, cuDNN bypassed, rounded
to f32), by conv route:

  cudnn   F.conv2d through cuDNN's own choice of algorithm, TF32 off
  native  F.conv2d with cuDNN bypassed (im2col + GEMM), TF32 off: the
          route models/qat._int_valued_conv takes

For each route: the elements that differ where B ≤ 2^24 (the algorithm's
own error), those that differ where B > 2^24, the B > 2^24 elements, the
share of the fake-quant trunk equal to the served int8 trunk
(quant.apply_graph_quant, blocks on), and the ms of one distillation step
(models/qat.distill_folded at the batch, the pipeline's head and tail).

Usage: python -m face_vijnana_yolov3_tpu_torch.scripts.qat_conv_exactness
       [--ckpt PATH] [--size 416] [--batch 8] [--seed 0] [--device DEV]

Without --ckpt the detector is the seeded random init with seeded BN
statistics; the batch is seeded uniform images. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from face_vijnana_yolov3_tpu_torch.models import darknet, qat, quant

EXACT_LIMIT = 2.0 ** 24


def _native(x_int, k_int, stride):
    with darknet.exact_f32(), torch.backends.cudnn.flags(enabled=False):
        return darknet.conv_nhwc(x_int, k_int, stride)


def _cudnn(x_int, k_int, stride):
    with darknet.exact_f32():
        return darknet.conv_nhwc(x_int, k_int, stride)


ROUTES = {"cudnn": _cudnn, "native": _native}


def _sums_f64(x, k, stride):
    """Exact conv sums of integer-valued operands: float64 holds every
    partial sum (below 2^28) exactly; cuDNN is bypassed."""
    with torch.backends.cudnn.flags(enabled=False):
        return darknet.conv_nhwc(x.double(), k.double(), stride)


@contextlib.contextmanager
def conv_route(route: str | None):
    """qat's conv swapped for ROUTES[route] inside the block (None: qat's
    own)."""
    saved = qat._int_valued_conv
    qat._int_valued_conv = saved if route is None else ROUTES[route]
    try:
        yield
    finally:
        qat._int_valued_conv = saved


def conv_exactness(folded: dict, x: torch.Tensor, ops: list[tuple], act_scales,
                   route: str | None = None) -> dict:
    """One fake-quant walk over x with every conv checked against the
    served sums; → {"differ_within", "differ_beyond", "beyond", "elements",
    "convs"} summed over the convs (within/beyond: B ≤ / > 2^24)."""
    totals = dict(differ_within=0, differ_beyond=0, beyond=0, elements=0, convs=0)

    def checked(x_int, k_int, stride):
        y = run(x_int, k_int, stride)
        served = _sums_f64(x_int, k_int, stride).float()
        beyond = _sums_f64(x_int.abs(), k_int.abs(), stride) > EXACT_LIMIT
        differ = y != served
        totals["differ_within"] += int((differ & ~beyond).sum())
        totals["differ_beyond"] += int((differ & beyond).sum())
        totals["beyond"] += int(beyond.sum())
        totals["elements"] += y.numel()
        totals["convs"] += 1
        return y

    with conv_route(route):
        run = qat._int_valued_conv
        qat._int_valued_conv = checked
        with torch.no_grad():
            qat.apply_graph_fakequant(folded, x, ops, act_scales)
    return totals


def measure(folded: dict, x: torch.Tensor, ops: list[tuple], act_scales, *,
            tail_blocks: int = 4, steps: int = 5) -> dict:
    """Per route: conv_exactness, the fake-quant trunk's share equal to the
    served int8 trunk, and the ms of one distillation step (the difference
    of a (steps + 1)-step and a 1-step distill_folded, over steps)."""
    from face_vijnana_yolov3_tpu_torch.models.detector import head_conv

    q = quant.to_device(quant.quantize_folded(folded, None, ops, act_scales=act_scales),
                        x.device)
    with torch.inference_mode():
        served = quant.apply_graph_quant(q, x, ops, fused_blocks=True)["trunk"]

    def head_fn(outs, prm):
        return head_conv(outs["trunk"], prm["head"], torch.float32)

    def distill_s(n):
        if x.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        qat.distill_folded(folded, x, ops, act_scales=act_scales, head_fn=head_fn,
                           steps=n, batch_size=x.shape[0], lr=1e-5,
                           tail_blocks=tail_blocks)
        if x.is_cuda:
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = {}
    for route in ROUTES:
        rec = conv_exactness(folded, x, ops, act_scales, route)
        with conv_route(route):
            with torch.no_grad():
                trunk = qat.apply_graph_fakequant(folded, x, ops, act_scales)["trunk"]
            rec["trunk_equal"] = float((trunk == served).float().mean())
            distill_s(1)  # warm: workspaces, the route's kernels
            rec["step_ms"] = (distill_s(steps + 1) - distill_s(1)) / steps * 1e3
        out[route] = rec
    return out


def main(argv=None) -> dict:
    from face_vijnana_yolov3_tpu_torch.api.face_detection import resolve_device
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default=None, help="a detector checkpoint (.pt)")
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    model = FaceDetectorModel(image_size=args.size, device=dev)
    if args.ckpt:
        from face_vijnana_yolov3_tpu_torch.core.checkpoints import load_checkpoint

        model.load_state_dict(load_checkpoint(args.ckpt))
    else:
        params, state = model.init_params(args.seed)
        params, state = darknet.perturb_batchnorm(params, state, model.ops, args.seed + 1)
        model.load_state_dict(params_from_jax(params, state))
    x = torch.from_numpy(np.random.default_rng(args.seed).uniform(
        size=(args.batch, args.size, args.size, 3)).astype(np.float32)).to(dev)
    folded = model.fold()
    act_scales = quant.calibrate_folded(folded, x, model.ops)
    out = {"size": args.size, "batch": args.batch, "ckpt": args.ckpt,
           "routes": measure(folded, x, model.ops, act_scales)}
    if dev.type == "cuda":
        out["device"] = torch.cuda.get_device_name(dev)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
