"""Darknet-53 / YOLOv3 op-IR and its eval-mode forward in PyTorch.

The op-IR (`trunk_graph`, `yolov3_graph`, `conv_layout`) is a plain-Python
copy of face_vijnana_yolov3_tpu/models/darknet.py:35-136 (that module imports
jax, so it cannot be imported here); tests/test_torch_darknet.py holds the
lists equal.

`apply_graph_train` is the training forward (JAX `apply_graph(train=True)`,
darknet.py:361-533) on explicit param/state dicts: BatchNorm on batch
statistics with the Keras momentum rule, optional int8 fake-quant (QAT) and
bf16 mixed precision. `Darknet` interprets the IR with eval-mode BatchNorm
exactly as the JAX `apply_graph(train=False)` does (darknet.py:496-503): BN runs in the JAX order
`(h - mean) * (rsqrt(var + eps) * gamma) + beta` — not nn.BatchNorm2d's —
with eps 1e-3, and leaky is `where(h > 0, h, 0.1 * h)`. Every k=3 conv pads 1
on both sides (stride 2 too, darknet.py:311-314). Activations run NCHW; the
public `forward` takes and returns NHWC like the JAX function.

State-dict keys keep the JAX tree names: `conv_{i}.weight` (OIHW),
`conv_{i}.bias` (bias convs only), `bnorm_{i}.gamma/beta/mean/var`
(face_vijnana_yolov3_tpu_torch/convert.py maps between the two).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.99  # Keras: moving = 0.99 * moving + 0.01 * batch
LEAKY_ALPHA = 0.1


def div_127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 as the f32 quotient on any device: divided by a 0-d tensor
    on x's device. CUDA turns a division by a Python number into a product
    with its f32 reciprocal, one ulp off the quotient on some elements; a
    fill, not a host copy, so that a captured program holds it."""
    return x / x.new_full((), 127.0)


# ------------------------------------------------------------------ graph IR

def _conv(idx, out_c, k=3, stride=1, bn=True, leaky=True):
    return ("conv", idx, out_c, k, stride, bn, leaky)


def _residual_stage(first_idx, n_blocks, c_half, c_full, ops):
    """One darknet residual stage: n_blocks of [1x1 c_half, 3x3 c_full] + add."""
    idx = first_idx
    for _ in range(n_blocks):
        ops.append(("save", "skip"))
        ops.append(_conv(idx, c_half, k=1))
        ops.append(_conv(idx + 1, c_full, k=3))
        ops.append(("add", "skip"))
        idx += 3
    return idx


def trunk_graph() -> list[tuple]:
    """Darknet-53 trunk conv_0..conv_73 → 13x13x1024 (the reference's YOLOV3Base)."""
    ops: list[tuple] = []
    ops.append(_conv(0, 32, k=3, stride=1))
    ops.append(_conv(1, 64, k=3, stride=2))
    _residual_stage(2, 1, 32, 64, ops)
    ops.append(_conv(5, 128, k=3, stride=2))
    _residual_stage(6, 2, 64, 128, ops)
    ops.append(_conv(12, 256, k=3, stride=2))
    _residual_stage(13, 8, 128, 256, ops)
    ops.append(("mark", "skip_36"))
    ops.append(_conv(37, 512, k=3, stride=2))
    _residual_stage(38, 8, 256, 512, ops)
    ops.append(("mark", "skip_61"))
    ops.append(_conv(62, 1024, k=3, stride=2))
    _residual_stage(63, 4, 512, 1024, ops)
    ops.append(("output", "trunk"))
    return ops


def yolov3_graph() -> list[tuple]:
    """Full 3-head YOLOv3 (make_yolov3_model parity)."""
    ops = trunk_graph()
    ops = [op for op in ops if op[0] != "output"]
    for idx, c, k in ((75, 512, 1), (76, 1024, 3), (77, 512, 1), (78, 1024, 3),
                      (79, 512, 1)):
        ops.append(_conv(idx, c, k=k))
    ops.append(("mark", "route_79"))
    ops.append(_conv(80, 1024, k=3))
    ops.append(_conv(81, 255, k=1, bn=False, leaky=False))
    ops.append(("output", "yolo_82"))
    ops.append(("restore", "route_79"))
    ops.append(_conv(84, 256, k=1))
    ops.append(("upsample",))
    ops.append(("concat", "skip_61"))
    for idx, c, k in ((87, 256, 1), (88, 512, 3), (89, 256, 1), (90, 512, 3),
                      (91, 256, 1)):
        ops.append(_conv(idx, c, k=k))
    ops.append(("mark", "route_91"))
    ops.append(_conv(92, 512, k=3))
    ops.append(_conv(93, 255, k=1, bn=False, leaky=False))
    ops.append(("output", "yolo_94"))
    ops.append(("restore", "route_91"))
    ops.append(_conv(96, 128, k=1))
    ops.append(("upsample",))
    ops.append(("concat", "skip_36"))
    for idx, c, k in ((99, 128, 1), (100, 256, 3), (101, 128, 1), (102, 256, 3),
                      (103, 128, 1), (104, 256, 3)):
        ops.append(_conv(idx, c, k=k))
    ops.append(_conv(105, 255, k=1, bn=False, leaky=False))
    ops.append(("output", "yolo_106"))
    return ops


def conv_layout(ops: list[tuple]) -> list[tuple[int, int, int, int, int, bool]]:
    """Enumerate convs as (idx, in_c, out_c, k, stride, bnorm) by walking the IR."""
    layout = []
    c = 3
    saved: dict[str, int] = {}
    for op in ops:
        kind = op[0]
        if kind == "conv":
            _, idx, out_c, k, stride, bn, _ = op
            layout.append((idx, c, out_c, k, stride, bn))
            c = out_c
        elif kind in ("save", "mark"):
            saved[op[1]] = c
        elif kind == "restore":
            c = saved[op[1]]
        elif kind == "concat":
            c = c + saved[op[1]]
    return layout


# ------------------------------------------------------------------ params

def init_graph_params(ops: list[tuple], seed: int | None = None):
    """Host numpy (params, state) trees in the JAX layout (HWIO kernels).

    The same trees, draw for draw, as the JAX `init_graph_params(ops, rng)`
    whose key yields this `seed` (darknet.py:150-156): kernels are
    uniform(±sqrt(6/fan_in)) from `np.random.default_rng(seed)` in conv
    order; `seed=None` gives zero kernels. With a seed, the BN gamma of every
    residual-ending conv starts at 0 so each residual branch starts as the
    identity (darknet.py:157-168).
    """
    params: dict = {}
    state: dict = {}
    np_rng = None if seed is None else np.random.default_rng(seed)
    residual_end: set[int] = set()
    prev_conv_idx = None
    for op in ops:
        if op[0] == "conv":
            prev_conv_idx = op[1]
        elif op[0] == "add" and prev_conv_idx is not None:
            residual_end.add(prev_conv_idx)
    for idx, in_c, out_c, k, _stride, bn in conv_layout(ops):
        shape = (k, k, in_c, out_c)
        if np_rng is None:
            kernel = np.zeros(shape, np.float32)
        else:
            limit = float(np.sqrt(6.0 / (k * k * in_c)))
            kernel = np_rng.uniform(-limit, limit, shape).astype(np.float32)
        entry = {"kernel": kernel}
        if not bn:
            entry["bias"] = np.zeros((out_c,), np.float32)
        params[f"conv_{idx}"] = entry
        if bn:
            gamma_init = 0.0 if (seed is not None and idx in residual_end) else 1.0
            params[f"bnorm_{idx}"] = {
                "gamma": np.full((out_c,), gamma_init, np.float32),
                "beta": np.zeros((out_c,), np.float32),
            }
            state[f"bnorm_{idx}"] = {
                "mean": np.zeros((out_c,), np.float32),
                "var": np.ones((out_c,), np.float32),
            }
    return params, state


def perturb_batchnorm(params: dict, state: dict, ops: list[tuple], seed: int):
    """Seeded BN statistics in place of init_graph_params' identity BN, for
    runs on random weights (in place; returns the trees).

    With gamma = 0 on every residual-ending conv, each residual branch folds
    to a zero kernel, and the int8 residual blocks would multiply zeros.
    Here every BN draws gamma ~ U(0.5, 1.5), beta and mean ~ N(0, 0.1) and
    var ~ U(0.5, 1.5) from `np.random.default_rng(seed)`, in key order,
    except the residual-ending convs, whose gamma ~ U(0.05, 0.15):
    branches of full gain grow the residual stream block by block until the
    head's logits lie far outside the sigmoid's range; small ones keep them
    O(1), so the postprocess finds boxes.
    """
    rng = np.random.default_rng(seed)
    residual_end = {ops[i][1] for i in range(len(ops) - 1)
                    if ops[i][0] == "conv" and ops[i + 1][0] == "add"}
    for key in sorted(k for k in params if k.startswith("bnorm_")):
        c = params[key]["gamma"].shape[0]
        lo, hi = ((0.05, 0.15) if int(key.split("_")[1]) in residual_end
                  else (0.5, 1.5))
        params[key]["gamma"] = rng.uniform(lo, hi, c).astype(np.float32)
        params[key]["beta"] = rng.normal(0, 0.1, c).astype(np.float32)
        state[key]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        state[key]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return params, state


# ------------------------------------------------------------------ modules

class BatchNormEval(nn.Module):
    """Eval-mode BatchNorm in the JAX order (darknet.py:497-499)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels, device=device))
        self.beta = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        scale = torch.rsqrt(self.var + BN_EPS) * self.gamma
        return ((h - self.mean[:, None, None]) * scale[:, None, None]
                + self.beta[:, None, None])


def leaky(h: torch.Tensor) -> torch.Tensor:
    return torch.where(h > 0, h, LEAKY_ALPHA * h)


class Darknet(nn.Module):
    """Eval-mode interpreter of a darknet op-IR (JAX `apply_graph(train=False)`)."""

    def __init__(self, ops: list[tuple], device=None):
        super().__init__()
        self.ops = ops
        for idx, in_c, out_c, k, stride, bn in conv_layout(ops):
            self.add_module(f"conv_{idx}", nn.Conv2d(
                in_c, out_c, k, stride=stride, padding=1 if k > 1 else 0,
                bias=not bn, device=device,
            ))
            if bn:
                self.add_module(f"bnorm_{idx}", BatchNormEval(out_c, device))
        self.requires_grad_(False)

    def run_nchw(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """Interpret the graph on an NCHW f32 batch; outputs stay NCHW."""
        saved: dict[str, torch.Tensor] = {}
        outputs: dict[str, torch.Tensor] = {}
        h = x
        for op in self.ops:
            kind = op[0]
            if kind == "conv":
                _, idx, _out_c, _k, _stride, bn, act = op
                h = getattr(self, f"conv_{idx}")(h)
                if bn:
                    h = getattr(self, f"bnorm_{idx}")(h)
                if act:
                    h = leaky(h)
            elif kind in ("save", "mark"):
                saved[op[1]] = h
            elif kind == "add":
                h = saved[op[1]] + h
            elif kind == "restore":
                h = saved[op[1]]
            elif kind == "concat":
                h = torch.cat([h, saved[op[1]]], dim=1)
            elif kind == "upsample":
                h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            elif kind == "output":
                outputs[op[1]] = h
            else:
                raise ValueError(f"unknown op {op}")
        return outputs

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """NHWC f32 batch → {output name: NHWC f32 tensor}, like the JAX apply."""
        outs = self.run_nchw(x.permute(0, 3, 1, 2).contiguous())
        return {k: v.permute(0, 2, 3, 1) for k, v in outs.items()}


# ------------------------------------------------------------------ folded fast path

def fold_graph_params(state_dict: dict, ops: list[tuple]) -> dict:
    """Fold eval BatchNorm into the conv kernels and biases (darknet.py:535-554).

    `state_dict` holds the module names (`conv_{i}.weight` OIHW,
    `bnorm_{i}.gamma/beta/mean/var`, `conv_{i}.bias` for convs without BN).
    Returns {f"conv_{i}": {"kernel": OIHW f32, "bias": f32}} on the same
    device, with the JAX arithmetic, op for op: scale = gamma / sqrt(var +
    eps) (not rsqrt), kernel * scale, bias = beta - mean * scale, each a
    separate IEEE rounding as the JAX package's eager fold computes them, so
    the folded params are bit-identical.
    """
    folded = {}
    for idx, _in_c, _out_c, _k, _stride, bn in conv_layout(ops):
        w = state_dict[f"conv_{idx}.weight"]
        if bn:
            gamma = state_dict[f"bnorm_{idx}.gamma"]
            beta = state_dict[f"bnorm_{idx}.beta"]
            mean = state_dict[f"bnorm_{idx}.mean"]
            var = state_dict[f"bnorm_{idx}.var"]
            # sqrt through float64 is the correctly rounded f32 sqrt (torch's
            # vectorised f32 sqrt on the CPU is not, XLA's is).
            scale = gamma / torch.sqrt((var + BN_EPS).double()).float()
            folded[f"conv_{idx}"] = {
                "kernel": w * scale[:, None, None, None],
                "bias": beta - mean * scale,
            }
        else:
            folded[f"conv_{idx}"] = {"kernel": w.clone(),
                                     "bias": state_dict[f"conv_{idx}.bias"].clone()}
    return folded


def front_end_index(ops: list[tuple], n_blocks: int) -> int:
    """Op index where reduced precision may begin when the first `n_blocks`
    graph segments run f32 (darknet.py:557-569): segment 1 is everything
    before the first ("save", ...) block opener, each further segment one
    residual block."""
    starts = [i for i, op in enumerate(ops) if op[0] == "save"]
    if n_blocks <= 0 or n_blocks > len(starts):
        raise ValueError(f"n_blocks must be in 1..{len(starts)}")
    return starts[n_blocks - 1]


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN convs and cuBLAS matmuls inside the block (the JAX
    f32 contract is Precision.HIGHEST); the previous flags come back after."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def conv_nhwc(h: torch.Tensor, kernel: torch.Tensor, stride: int) -> torch.Tensor:
    """NHWC activations × OIHW kernel, pad k//2 on both sides, in the
    tensors' own dtype (a bf16 conv accumulates in f32 and returns bf16,
    as XLA's bf16 conv with no preferred type does) → NHWC."""
    k = kernel.shape[-1]
    y = F.conv2d(h.permute(0, 3, 1, 2), kernel, stride=stride, padding=k // 2)
    return y.permute(0, 2, 3, 1)


def apply_graph_folded(folded: dict, x: torch.Tensor, ops: list[tuple], *,
                       compute_dtype=torch.bfloat16, f32_front_ops: int = 0,
                       observe=None) -> dict[str, torch.Tensor]:
    """Inference forward with conv+BN folded (darknet.py:572-625), NHWC.

    Each conv runs in `compute_dtype` (bf16: bf16 operands and output), adds
    its f32 bias in f32, applies leaky and casts back to the op dtype; ops
    before `f32_front_ops` run f32 whatever `compute_dtype` is. That guard
    runs at Precision.HIGH (bf16x3) in the JAX package, which has no GPU
    counterpart: here it is plain f32 with TF32 off, a deliberate
    divergence. `observe(h)`, when given, sees the activation after every
    op (the calibration walk of models/quant.py). Outputs are f32.
    """
    saved: dict[str, torch.Tensor] = {}
    outputs: dict[str, torch.Tensor] = {}
    h = x
    with exact_f32():
        for i, op in enumerate(ops):
            kind = op[0]
            op_dtype = torch.float32 if i < f32_front_ops else compute_dtype
            if kind == "conv":
                _, idx, _out_c, _k, stride, _bn, act = op
                p = folded[f"conv_{idx}"]
                h = conv_nhwc(h.to(op_dtype), p["kernel"].to(op_dtype), stride)
                h = h + p["bias"]
                if act:
                    h = leaky(h)
                h = h.to(op_dtype)
            elif kind in ("save", "mark"):
                saved[op[1]] = h
            elif kind == "add":
                h = saved[op[1]] + h
            elif kind == "restore":
                h = saved[op[1]]
            elif kind == "concat":
                h = torch.cat([h, saved[op[1]]], dim=-1)
            elif kind == "upsample":
                h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            elif kind == "output":
                outputs[op[1]] = h.float()
            else:
                raise ValueError(f"unknown op {op}")
            if observe is not None:
                observe(h)
    return outputs


# ------------------------------------------------------------------ training forward

def split_state_dict(sd: dict) -> tuple[dict, dict]:
    """A module state dict → (params, state): the trained tensors (conv
    weights and biases, BN gamma/beta, the head) and the BN moving
    statistics (`bnorm_{i}.mean/var`), the JAX package's params/state split."""
    params = {k: v for k, v in sd.items() if not k.endswith((".mean", ".var"))}
    state = {k: v for k, v in sd.items() if k.endswith((".mean", ".var"))}
    return params, state


def _wide(h: torch.Tensor) -> torch.Tensor:
    """h in f32 (the training forward's statistics and outputs), or kept in
    f64: a float64 forward is exact enough to hold the data-parallel
    collectives to one process (tests/test_torch_multiprocess.py)."""
    return h if h.dtype == torch.float64 else h.float()


def _act_fq(h: torch.Tensor, group=None):
    """Per-channel int8 activation fake-quant of an NCHW activation with a
    straight-through gradient (darknet.py:254-267): s = max(batch maxabs,
    1e-6) / 127 (`div_127`, the f32 quotient), held constant; value hf +
    (clip(round(hf / s), ±127) * s - hf), whose gradient is the identity.
    torch.round rounds half to even, as jnp.round. With a data-parallel
    `group` the maxabs is the whole batch's (a MAX over the group). Returns
    (f32 value, (C,) scale)."""
    hf = _wide(h)
    amax = hf.detach().abs().amax(dim=(0, 2, 3))
    if group is not None:
        from face_vijnana_yolov3_tpu_torch.parallel.mesh import all_reduce_max_

        amax = all_reduce_max_(amax, group)
    s = div_127(torch.clamp_min(amax, 1e-6))
    sb = s[:, None, None]
    q = torch.clamp(torch.round(hf / sb), -127.0, 127.0) * sb
    return hf + (q - hf).detach(), s


def _global_moments(hf: torch.Tensor, group):
    """(E[x], E[x²]) per channel of an NCHW f32 activation over every rank's
    rows: the sums and the element count all-reduced over `group`
    (differentiably)."""
    from face_vijnana_yolov3_tpu_torch.parallel.mesh import all_reduce_sum

    c = hf.shape[1]
    count = hf.new_full((1,), hf.numel() / c)
    sums = all_reduce_sum(torch.cat([hf.sum(dim=(0, 2, 3)),
                                     (hf * hf).sum(dim=(0, 2, 3)), count]), group)
    return sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]


def _weight_fq(kernel: torch.Tensor, s_in: torch.Tensor | None) -> torch.Tensor:
    """Per-output-channel int8 weight fake-quant of an OIHW kernel with the
    input activation scales folded in, as quantize_folded deploys it
    (darknet.py:270-292), straight-through; s_in None = no input scales."""
    k = _wide(kernel)
    k_eff = k * s_in[None, :, None, None] if s_in is not None else k
    w_scale = div_127(torch.clamp_min(k_eff.detach().abs().amax(dim=(1, 2, 3)), 1e-8))
    ws = w_scale[:, None, None, None]
    q = torch.clamp(torch.round(k_eff / ws), -127.0, 127.0) * ws
    k_fq = k_eff + (q - k_eff).detach()
    return k_fq / s_in[None, :, None, None] if s_in is not None else k_fq


def fakequant_skip_ops(ops: list[tuple]) -> set[int]:
    """Op indices whose activation requant is deferred to after the next
    "add" (the fused-residual rule, darknet.py:295-308)."""
    return {i for i, op in enumerate(ops)
            if op[0] == "conv" and i + 1 < len(ops) and ops[i + 1][0] == "add"}


def remat_segments(ops: list[tuple]) -> list[list[tuple]]:
    """Split a linear (trunk-like) graph into segments that end at each
    residual add (darknet.py:340-358): after an add nothing from inside the
    block is live, so a checkpointed segment saves only its input."""
    if any(op[0] in ("restore", "concat") for op in ops):
        raise ValueError("remat segmentation requires a linear trunk graph")
    segments: list[list[tuple]] = [[]]
    for op in ops:
        segments[-1].append(op)
        if op[0] == "add":
            segments.append([])
    if not segments[-1]:
        segments.pop()
    return segments


def _apply_graph_remat(params, state, x, ops, *, remat, compute_dtype, bn_momentum,
                       fakequant, group=None):
    """apply_graph_train segment by segment (darknet.py:404-443): the first
    `remat` segments (all of them for True) run under
    torch.utils.checkpoint, which keeps only each segment's input and
    recomputes its inside in the backward. Each segment is a call of its
    own, so with fakequant its input is fake-quantized again (idempotent on
    an int8 grid) and it returns its output cast to `compute_dtype`, as in
    the JAX package. The returned state merges each segment's BN keys."""
    from torch.utils.checkpoint import checkpoint

    outputs: dict[str, torch.Tensor] = {}
    new_state = dict(state)
    h = x
    segs = remat_segments(ops)
    n_ckpt = len(segs) if remat is True else int(remat)
    for i, seg_ops in enumerate(segs):
        core = [op for op in seg_ops if op[0] != "output"]

        def seg_fn(h, core=core):
            outs, st = apply_graph_train(
                params, state, h, core + [("output", "__h")],
                compute_dtype=compute_dtype, bn_momentum=bn_momentum,
                fakequant=fakequant, group=group)
            seg_bn = {f"bnorm_{op[1]}" for op in core if op[0] == "conv" and op[5]}
            return outs["__h"].to(compute_dtype), {
                k: v for k, v in st.items() if k.rsplit(".", 1)[0] in seg_bn}

        if i < n_ckpt:
            # The forward draws no random numbers: nothing to stash, and a
            # captured training program could not read the RNG state.
            h, st = checkpoint(seg_fn, h, use_reentrant=False, preserve_rng_state=False)
        else:
            h, st = seg_fn(h)
        new_state.update(st)
        for op in seg_ops:
            if op[0] == "output":
                outputs[op[1]] = h.float()
    return outputs, new_state


def apply_graph_train(params: dict, state: dict, x: torch.Tensor, ops: list[tuple], *,
                      compute_dtype=torch.float32, bn_momentum: float | None = None,
                      fakequant: bool = False, remat: bool | int = False,
                      group=None) -> tuple[dict, dict]:
    """Training-mode forward (JAX `apply_graph(train=True)`): x (B, S, S, 3)
    NHWC → ({output name: NHWC f32}, new_state).

    params/state are state-dict-named tensors (`split_state_dict`). Each
    conv casts its input and kernel to `compute_dtype` (bf16: a bf16 conv
    with a bf16 result, f32 accumulation, as XLA's with no preferred type);
    BatchNorm takes batch statistics in f32, var = max(E[x^2] - E[x]^2, 0)
    (biased), normalises as (h - mean) * (rsqrt(var + eps) * gamma) + beta,
    and updates moving = m * moving + (1 - m) * batch for mean and var with
    m = bn_momentum or 0.99 (not nn.BatchNorm2d's rule, which weights the
    other way and keeps an unbiased variance); leaky runs in f32, then the
    activation is cast back to `compute_dtype`. fakequant adds the int8
    fake-quant of every requant position and of every kernel (QAT). f32
    convs need TF32 off (the caller sets it: JAX Precision.HIGHEST).
    Activations run NCHW inside. remat (True, or an int N for the first N
    segments) checkpoints residual-block segments (`_apply_graph_remat`).

    group: the data-parallel process group when x is this rank's share of a
    global batch. The BN moments are then the global batch's (the sums and
    the count through a differentiable all-reduce, so each rank's backward
    also sees the other ranks' rows) and the fake-quant scales the global
    maxabs, as the JAX program computes them over its sharded batch.
    """
    if remat:
        return _apply_graph_remat(params, state, x, ops, remat=remat,
                                  compute_dtype=compute_dtype,
                                  bn_momentum=bn_momentum, fakequant=fakequant,
                                  group=group)
    mom = BN_MOMENTUM if bn_momentum is None else bn_momentum
    saved: dict[str, torch.Tensor] = {}
    saved_scale: dict[str, torch.Tensor | None] = {}
    outputs: dict[str, torch.Tensor] = {}
    new_state = dict(state)
    h = x.permute(0, 3, 1, 2)
    fq_scale = None
    fq_skip = fakequant_skip_ops(ops) if fakequant else set()
    if fakequant:
        h, fq_scale = _act_fq(h, group)
    for i, op in enumerate(ops):
        kind = op[0]
        if kind == "conv":
            _, idx, _out_c, k, stride, bn, act = op
            kernel = params[f"conv_{idx}.weight"]
            if fakequant:
                kernel = _weight_fq(kernel, fq_scale)
            h = F.conv2d(h.to(compute_dtype), kernel.to(compute_dtype),
                         stride=stride, padding=k // 2)
            if bn:
                name = f"bnorm_{idx}"
                hf = _wide(h)
                if group is None:
                    mean = hf.mean(dim=(0, 2, 3))
                    ex2 = (hf * hf).mean(dim=(0, 2, 3))
                else:
                    mean, ex2 = _global_moments(hf, group)
                var = torch.clamp_min(ex2 - mean * mean, 0.0)
                inv = torch.rsqrt(var + BN_EPS)
                scale = inv * params[f"{name}.gamma"]
                h = ((hf - mean[:, None, None]) * scale[:, None, None]
                     + params[f"{name}.beta"][:, None, None])
                new_state[f"{name}.mean"] = (state[f"{name}.mean"] * mom
                                             + mean.detach() * (1 - mom))
                new_state[f"{name}.var"] = (state[f"{name}.var"] * mom
                                            + var.detach() * (1 - mom))
            else:
                h = h + params[f"conv_{idx}.bias"][:, None, None]
            if act:
                h = leaky(h)
            if fakequant and i not in fq_skip:
                h, fq_scale = _act_fq(h, group)
            h = h.to(compute_dtype)
        elif kind in ("save", "mark"):
            saved[op[1]] = h
            saved_scale[op[1]] = fq_scale
        elif kind == "add":
            h = saved[op[1]] + h
            if fakequant:
                h, fq_scale = _act_fq(h, group)
                h = h.to(compute_dtype)
        elif kind == "restore":
            h = saved[op[1]]
            fq_scale = saved_scale.get(op[1])
        elif kind == "concat":
            h = torch.cat([h, saved[op[1]]], dim=1)
            if fakequant:
                h, fq_scale = _act_fq(h, group)
                h = h.to(compute_dtype)
        elif kind == "upsample":
            h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        elif kind == "output":
            outputs[op[1]] = _wide(h).permute(0, 2, 3, 1)
        else:
            raise ValueError(f"unknown op {op}")
    return outputs, new_state
