"""Distillation QAT: refine the folded kernels so the int8 program matches
the f32 teacher (`int8_qat_steps`).

Port of face_vijnana_yolov3_tpu/models/qat.py. A short label-free fine-tune
of the FOLDED conv kernels and biases: the fake-quant forward
(`apply_graph_fakequant`) replays the int8 serving program of
models/quant.py in f32 with straight-through estimators through the rounds,
and Adam (optax's form, train/optimizer.OptaxAdam) moves the kernels so
that its head reproduces the f32 folded head on the calibration images.
Activation scales stay frozen (they are baked into the serving program);
weight scales are recomputed from the live kernel each step, as
quantize_folded computes them from the refined kernels, so the deployed
program is the trained one.

Arithmetic, as the port's serving path computes it: the activation requant
multiplies by f32(1/s) (reciprocal in float64, then cast), never divides;
the weight quantization divides, k_eff / w_scale (w_scale itself a true
f32 quotient, on the card too), with the input scales folded along the
OIHW input channels (axis 1); the conv runs in f32 with TF32 off on
integer-valued operands, cuDNN bypassed (`_int_valued_conv`), so its sums
are exact while they stay below 2^24; the epilogue `acc * w_scale + bias`
and the fused residual `skip_int * skip_s + y` are single-rounding FMAs,
as the kernels' epilogues (ops/conv_int8.fma_f32), with the plain
product's gradient. So the fake-quant head equals `apply_graph_quant`'s
bit for bit on the CPU (tests/test_torch_qat.py) and on the card wherever
no f32 sum passes 2^24; chip_smoke.py phase 16 holds each fake-quant conv
to its exact sums on the card (scripts/qat_conv_exactness.py).
"""

from __future__ import annotations

import numpy as np
import torch

from face_vijnana_yolov3_tpu_torch.models import darknet
from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import fma_f32
from face_vijnana_yolov3_tpu_torch.train.optimizer import OptaxAdam


def _ste_round_clip(z: torch.Tensor) -> torch.Tensor:
    """round (half to even) + clip to [-127, 127] with a straight-through
    gradient: z + stop_gradient(r - z), in that order, as the JAX form."""
    r = torch.clamp(torch.round(z), -127.0, 127.0)
    return z + (r - z).detach()


class _Fma(torch.autograd.Function):
    """a * b + c rounded once (fma_f32), with the gradient of a * b + c."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        ctx.c_shape = c.shape
        return fma_f32(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return ((g * b).sum_to_size(a.shape), (g * a).sum_to_size(b.shape),
                g.sum_to_size(ctx.c_shape))


def _device_scales(act_scales, device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """[(f32(s), f32(1/s))] per position on `device`, the reciprocal taken
    in float64 (quant.to_device's rule), in one host-to-device copy."""
    s64 = [np.asarray(s, np.float64) for s in act_scales]
    flat = torch.from_numpy(np.concatenate(
        [np.concatenate([s.astype(np.float32), (1.0 / s).astype(np.float32)])
         for s in s64])).to(device)
    out, off = [], 0
    for s in s64:
        out.append((flat[off:off + s.size], flat[off + s.size:off + 2 * s.size]))
        off += 2 * s.size
    return out


def _fq_int(h: torch.Tensor, sc: tuple) -> torch.Tensor:
    """The int8 the serving requant stores, as an f32 value with an STE
    gradient: clip(round(h * f32(1/s))). sc = (f32(s), f32(1/s))."""
    return _ste_round_clip(h * sc[1])


def _fq_act(h: torch.Tensor, sc: tuple) -> torch.Tensor:
    """Per-channel activation fake-quant (NHWC, scales (C,)): the serving
    requant's int8, dequantized by * f32(s)."""
    return _fq_int(h, sc) * sc[0]


def _int_valued_conv(x_int: torch.Tensor, k_int: torch.Tensor, stride: int) -> torch.Tensor:
    """The f32 conv of integer-valued operands (NHWC × OIHW), exact wherever
    Σ|x|·|k| ≤ 2^24: TF32 off, and cuDNN bypassed, so the sums are
    PyTorch's im2col + GEMM products accumulated in f32. cuDNN's FFT and
    Winograd algorithms transform the operands first and are not exact on
    integers (scripts/qat_conv_exactness.py measures both routes)."""
    with darknet.exact_f32(), torch.backends.cudnn.flags(enabled=False):
        return darknet.conv_nhwc(x_int, k_int, stride)


def _fq_conv(h_fq: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, op: tuple,
             sc_in: tuple, *, skip: tuple | None = None) -> torch.Tensor:
    """One fake-quant conv replaying the int8 serving conv (NHWC in, OIHW
    kernel): the input's int8 recovered from its fake-quant value, the
    kernel with the input scales folded in, quantized per output channel
    against w_scale = max(maxabs, 1e-8) / 127 of the live kernel (no
    gradient through w_scale), the conv of the two integer-valued tensors
    in f32, then the epilogue FMA, leaky and, with skip = (its int8 value,
    its f32 scale), the fused residual FMA. Returns the pre-requant f32."""
    _, _idx, _out_c, _k, stride, _bn, leaky = op
    x_int = _fq_int(h_fq, sc_in)
    k_eff = kernel * sc_in[0][None, :, None, None]
    amax = torch.clamp_min(k_eff.detach().abs().amax(dim=(1, 2, 3)), 1e-8)
    # quantize_folded's f32 quotient on the card too (darknet.div_127).
    w_scale = darknet.div_127(amax)
    k_int = _ste_round_clip(k_eff / w_scale[:, None, None, None])
    acc = _int_valued_conv(x_int, k_int, stride)
    y = _Fma.apply(acc, w_scale, bias)
    if leaky:
        y = darknet.leaky(y)
    if skip is not None:
        y = _Fma.apply(skip[0], skip[1], y)
    return y


def apply_graph_fakequant(folded_params: dict, x: torch.Tensor, ops: list[tuple],
                          act_scales) -> dict[str, torch.Tensor]:
    """Differentiable twin of quant.apply_graph_quant(fuse_residual=True)
    (qat.py:105-152 of the JAX package).

    folded_params: f32 folded {"conv_i": {"kernel" OIHW, "bias"}}, the
    trainable leaves. x: (B, H, W, 3) f32 NHWC. act_scales: the frozen
    per-position scale vectors (quant.calibrate_folded). Returns the
    outputs dict of apply_graph_quant (dequantized f32). A conv followed by
    an "add" adds the skip in its epilogue and fake-quantizes once, at the
    post-add position's scale, as the fused serving path.
    """
    return _fakequant_walk(folded_params, x, ops, _device_scales(act_scales, x.device))


def _fakequant_walk(folded_params: dict, x: torch.Tensor, ops: list[tuple],
                    scales: list[tuple]) -> dict[str, torch.Tensor]:
    """`apply_graph_fakequant` on the scales already on x's device
    (`_device_scales`), so that a training program copies nothing from the
    host."""
    saved: dict[str, tuple[torch.Tensor, tuple]] = {}
    outputs: dict[str, torch.Tensor] = {}
    h = _fq_act(x.float(), scales[0])
    sc = scales[0]
    skip_add = False
    for i, op in enumerate(ops):
        kind = op[0]
        sc_out = scales[i + 1]
        if skip_add:  # consumed by the previous conv's fused epilogue
            skip_add = False
            continue
        if kind == "conv":
            p = folded_params[f"conv_{op[1]}"]
            skip = None
            if i + 1 < len(ops) and ops[i + 1][0] == "add":
                h_skip, sc_skip = saved[ops[i + 1][1]]
                skip = (_fq_int(h_skip, sc_skip), sc_skip[0])
                sc_out = scales[i + 2]
                skip_add = True
            y = _fq_conv(h, p["kernel"], p["bias"], op, sc, skip=skip)
            h, sc = _fq_act(y, sc_out), sc_out
        elif kind in ("save", "mark"):
            saved[op[1]] = (h, sc)
        elif kind == "add":
            h, sc = _fq_act(saved[op[1]][0] + h, sc_out), sc_out
        elif kind == "restore":
            h, sc = saved[op[1]]
        elif kind == "concat":
            h = torch.cat([h, saved[op[1]][0]], dim=-1)
            h, sc = _fq_act(h, sc_out), sc_out
        elif kind == "upsample":
            h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        elif kind == "output":
            outputs[op[1]] = h
        else:
            raise ValueError(f"unknown op {op}")
    return outputs


def _leaves(out) -> list[torch.Tensor]:
    """The output leaves in jax.tree_util order (a dict by sorted key)."""
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return [out]


def distill_folded(folded_params: dict, images, ops: list[tuple], *, act_scales,
                   head_fn=None, steps: int = 200, batch_size: int = 8,
                   lr: float = 1e-5, seed: int = 0, log_every: int = 0,
                   student_init: dict | None = None, tail_blocks: int = 0):
    """Refine folded params so the fake-quant forward matches the f32
    teacher (qat.py:155-268 of the JAX package); → (refined folded params,
    per-step losses).

    images: (N, S, S, 3) letterboxed f32 (numpy or a tensor), moved to the
    params' device. head_fn(outs, folded) → the model output from the
    graph outputs, or None to distill on the graph outputs. The teacher is
    the f32 folded forward of folded_params (TF32 off), computed once; the
    loss is the sum over output leaves of each leaf's mean squared error.
    Each step takes `batch_size` images drawn by
    np.random.default_rng(seed).choice(n, batch_size, replace=False) and
    applies one optax-form Adam step (OptaxAdam). "head" never trains;
    tail_blocks > 0 trains only the convs from the last `tail_blocks`
    residual blocks on (quant.tail_start_index), the rest stay at their
    start values. student_init: the student's start (default
    folded_params).

    Each step replays one captured training program (the JAX package's
    jitted `step`; train/trainer.program_step) whose carry is the trainable
    leaves and the Adam state; the drawn indices are its one input, the
    images and the teacher's outputs stay on the device, closed over. The
    call runs under train/trainer.deterministic().
    """
    from face_vijnana_yolov3_tpu_torch.models.quant import tail_start_index
    from face_vijnana_yolov3_tpu_torch.train import trainer

    device = folded_params[next(iter(folded_params))]["kernel"].device

    def plain(p: dict) -> dict:  # normal tensors (not inference ones), detached
        return {k: {n: t.detach().clone() for n, t in v.items()} for k, v in p.items()}

    with torch.inference_mode(False), trainer.deterministic():
        teacher_params = plain(folded_params)
        start = plain(folded_params if student_init is None else student_init)
        x_all = torch.as_tensor(np.asarray(images, np.float32) if not isinstance(
            images, torch.Tensor) else images, dtype=torch.float32, device=device).clone()
        n = x_all.shape[0]
        batch_size = min(batch_size, n)
        trainable_convs = None  # None: every conv trains
        if tail_blocks:
            t0 = tail_start_index(ops, tail_blocks)
            trainable_convs = {f"conv_{op[1]}" for op in ops[t0:] if op[0] == "conv"}

        def is_trainable(k):
            return k != "head" and (trainable_convs is None or k in trainable_convs)

        def model_out(prm, x, fn):
            outs = fn(prm, x)
            return outs if head_fn is None else head_fn(outs, prm)

        with torch.no_grad():
            teacher = _leaves(model_out(
                teacher_params, x_all,
                lambda p, x: darknet.apply_graph_folded(p, x, ops,
                                                        compute_dtype=torch.float32)))
        scales = _device_scales(act_scales, device)
        flat = {f"{k}.{n}": t for k, v in start.items() if is_trainable(k)
                for n, t in v.items()}
        opt = OptaxAdam(lr)

        def step(flat, opt_state, idx):
            """One step of the JAX package's jitted `step`: the fake-quant
            loss of the drawn images and its gradients, Adam, p + u."""
            leaves = {k: t.detach().requires_grad_(True) for k, t in flat.items()}
            prm = {k: {n: leaves.get(f"{k}.{n}", t) for n, t in v.items()}
                   for k, v in start.items()}
            with torch.enable_grad():
                pred = _leaves(model_out(prm, x_all[idx],
                                         lambda p, x: _fakequant_walk(p, x, ops, scales)))
                loss = sum(torch.mean(torch.square(a - t[idx]))
                           for a, t in zip(pred, teacher))
                grads = torch.autograd.grad(loss, list(leaves.values()))
            updates, opt_state = opt.update(dict(zip(leaves, grads)), opt_state)
            with torch.no_grad():
                new = torch._foreach_add(list(leaves.values()),
                                         [updates[k] for k in leaves])
            return dict(zip(leaves, new)), opt_state, loss.detach()

        run = trainer.program_step(trainer.ProgramCache(device, train=True),
                                   ("distill", batch_size, tail_blocks), step, 2)
        opt_state = opt.init(flat)
        rng = np.random.default_rng(seed)
        losses = []
        for it in range(steps):
            idx = torch.from_numpy(rng.choice(n, size=batch_size, replace=False)).to(device)
            flat, opt_state, loss = run(flat, opt_state, idx)
            losses.append(float(loss))
            if log_every and (it % log_every == 0 or it == steps - 1):
                print(f"[qat] step {it}: distill mse {losses[-1]:.3e}")
        return plain({k: {n: flat.get(f"{k}.{n}", t) for n, t in v.items()}
                      for k, v in start.items()}), losses
