"""Post-training int8 quantization for the folded serving path.

Port of face_vijnana_yolov3_tpu/models/quant.py (the scheme is described
there): per-output-channel int8 weights with the per-channel input
activation scales folded in, per-channel static activation scales at every
graph position calibrated from an f32 folded forward, int8 convs with fused
epilogues (ops/conv_int8.py) and, optionally, whole residual blocks fused
into one kernel (ops/block_int8.py). The 6-channel head stays bf16.

qparams (the port's layout; convert.qparams_from_jax gives it from the JAX
package's):
  "conv_{i}":   {"kernel_q": int8 OHWI, "w_scale": (Cout,) f32, "bias": f32}
  "act_scales": len(ops) + 1 float64 numpy vectors, entry 0 the input's
  "head":       folded head {"kernel" OIHW f32, "bias"}
  "dense1":     the identifier's dense layer {"weight" (D, flat), "bias"},
                served bf16 (models/identifier.py)
  "tail_start"/"tail": with a bf16 tail, the op index where int8 stops and
                the folded params that run the rest in bf16
  "bf16_ops"/"bf16":   conv indices run as folded-bf16 islands, and theirs
`to_device` adds the device copies and the f32 scale / inverse-scale
vectors the walk uses; `apply_graph_quant` calls it.

Calibration takes exact maxabs, a percentile, "auto" or the "msegrid"
grid search (`calibrate_folded_msegrid`); `quantize_folded(bias_correct=True)`
folds the measured mean quantization error into the biases
(`bias_correct_quant`); `int8_error_profile` measures each int8 conv's
error against the f32 twin, to name the convs worth a bf16 island.
Distillation QAT (`int8_qat_steps`) refines the folded kernels against
the frozen scales before quantize_folded (models/qat.py); the int8 front
guard of bf16 serving is a program whose bf16 tail starts after the guard
segments (`bf16_tail_blocks`).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from face_vijnana_yolov3_tpu_torch.models import darknet
from face_vijnana_yolov3_tpu_torch.ops.block_int8 import block_eligible, block_int8
from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import (
    conv_acc_reference,
    conv_int8,
    fma_f32,
    quantize,
)

# Candidate clip percentiles scored by "auto" calibration (plus exact maxabs)
# and the margin a clip must win by (quant.py:41-62).
AUTO_CALIB_PERCENTILES = (99.99, 99.9)
AUTO_CALIB_MARGIN = 0.3
# "msegrid": a log-spaced clip-ratio grid searched per channel by measured
# round-trip MSE, picked on the host in f64 (quant.py:45-47).
MSEGRID_CANDIDATES = 96
MSEGRID_LO = 0.002
MSEGRID_TOL = 0.05


def _percentiles(a: torch.Tensor, percentiles) -> torch.Tensor:
    """jnp.percentile(a, percentiles, axis=0), 'linear' method, for a (N, C)
    tensor → (len(percentiles), C) f32.

    The JAX arithmetic: q = f32(p) / 100, position q * (f32(N) - 1) in f32,
    floor and ceil, weights (1 - frac, frac). The order statistics come from
    one `topk` over the top of each column (torch.quantile refuses inputs
    above 2^24 elements; conv_0's output at 16 calibration images is 88.6 M).
    """
    n = a.shape[0]
    q = torch.tensor(percentiles, dtype=torch.float32, device=a.device) / 100
    pos = q * (torch.tensor(float(n), dtype=torch.float32, device=a.device) - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    low_i = low.clamp(0, n - 1).long()
    high_i = high.clamp(0, n - 1).long()
    kk = n - int(low_i.min())
    top = torch.topk(a.t(), kk, dim=1).values.t()  # (kk, C), descending
    low_v = top[n - 1 - low_i]
    high_v = top[n - 1 - high_i]
    return low_v * low_w[:, None] + high_v * high_w[:, None]


# f32(1 / 127). The JAX package's calibration walks run jitted
# (quant.py:157, :260), and XLA rewrites their grids' division by the
# constant 127 into a product with its f32 reciprocal (tests/
# test_torch_quant_quotients.py reads it in the compiled program). CUDA does
# the same for a tensor divided by a Python number, the CPU divides; the
# grids below write the product, so both devices compute the JAX walk's.
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def auto_grid(cands: torch.Tensor) -> torch.Tensor:
    """The "auto" calibration's candidate scales max(cands, 1e-8) / 127, as
    the JAX package's jitted walk computes them (quant.py:112)."""
    return torch.clamp_min(cands, 1e-8) * INV_127


def msegrid_grid(m: torch.Tensor, ratios: torch.Tensor) -> torch.Tensor:
    """msegrid's (J, C) candidate scales max(m, 1e-8) * ratio_j / 127 for
    the (C,) maxabs m, as the jitted walk computes them (quant.py:230)."""
    return (torch.clamp_min(m, 1e-8)[None, :] * ratios[:, None]) * INV_127


def _calib_stat(h: torch.Tensor, percentile) -> torch.Tensor:
    """Per-channel range statistic of one activation (quant.py:102-126)."""
    a = h.abs().reshape(-1, h.shape[-1]).float()
    if percentile is None:
        return a.amax(dim=0)
    if percentile == "auto":
        cands = torch.cat([a.amax(dim=0, keepdim=True),
                           _percentiles(a, AUTO_CALIB_PERCENTILES)])  # (3, C)
        s = auto_grid(cands)
        # |x| round-trip error == signed round-trip error, as in the JAX code.
        err = torch.stack([
            torch.mean(torch.square(
                torch.round(a / s[j]).clamp(-127, 127) * s[j] - a), dim=0)
            for j in range(cands.shape[0])])
        clip_best = torch.argmin(err[1:], dim=0) + 1
        clip_err = torch.gather(err, 0, clip_best[None])[0]
        pick = torch.where(clip_err < AUTO_CALIB_MARGIN * err[0], clip_best, 0)
        return torch.gather(cands, 0, pick[None])[0]
    return _percentiles(a, (float(percentile),))[0]


def calibrate_folded(folded: dict, x: torch.Tensor, ops: list[tuple], *,
                     percentile: float | str | None = None) -> list[np.ndarray]:
    """Per-position per-channel activation scale vectors from an f32 folded
    forward (quant.py:65-166): len(ops) + 1 float64 (C,) vectors, entry 0
    the input's. percentile: None = exact per-channel maxabs; a number =
    that percentile of |activation|; "auto" = maxabs unless a
    AUTO_CALIB_PERCENTILES clip cuts the measured int8 round-trip MSE below
    AUTO_CALIB_MARGIN of maxabs's. The statistics stay on x's device; one
    copy brings them back. TF32 is off in the forward (exact_f32).
    """
    if isinstance(percentile, str) and percentile.startswith("msegrid"):
        tol = (float(percentile.split(":", 1)[1]) if ":" in percentile
               else MSEGRID_TOL)
        return calibrate_folded_msegrid(folded, x, ops, tol=tol)
    if isinstance(percentile, str) and percentile != "auto":
        raise ValueError(f"int8 calibration {percentile!r}: expected None, a "
                         "percentile, 'auto' or 'msegrid[:tol]'")
    x = torch.as_tensor(x, dtype=torch.float32)
    stats = [_calib_stat(x, percentile)]
    darknet.apply_graph_folded(
        folded, x, ops, compute_dtype=torch.float32,
        observe=lambda h: stats.append(_calib_stat(h, percentile)))
    flat = torch.cat(stats).cpu().numpy().astype(np.float64)
    out, off = [], 0
    for c in _position_channels(ops, int(x.shape[-1])):
        out.append(np.maximum(flat[off: off + c], 1e-8) / 127.0)
        off += c
    if off != flat.size:
        raise AssertionError(f"calibration walk gave {flat.size} values, "
                             f"the graph has {off} channels")
    return out


def msegrid_ratios(n_cand: int = MSEGRID_CANDIDATES,
                   lo: float = MSEGRID_LO) -> np.ndarray:
    """Log-spaced clip ratios in (lo, 1.0], the last exactly 1.0 (maxabs)."""
    r = np.exp(np.linspace(np.log(lo), 0.0, n_cand))
    r[-1] = 1.0
    return r


def _msegrid_stat(h: torch.Tensor, ratios: torch.Tensor) -> torch.Tensor:
    """[maxabs (C,), round-trip MSE (J, C) flattened] of one activation, f32
    (quant.py:225-232): candidate j's grid is max(m, 1e-8) * ratio_j / 127.
    One candidate at a time, so no (J, N, C) tensor is ever made."""
    a = h.abs().reshape(-1, h.shape[-1]).float()
    m = a.amax(dim=0)
    s = msegrid_grid(m, ratios)  # (J, C)
    err = torch.stack([
        torch.mean(torch.square(
            torch.round(a / s[j]).clamp(-127, 127) * s[j] - a), dim=0)
        for j in range(s.shape[0])])
    return torch.cat([m, err.reshape(-1)])


def calibrate_folded_msegrid(folded: dict, x, ops: list[tuple], *,
                             tol: float = MSEGRID_TOL) -> list[np.ndarray]:
    """Deterministic per-channel calibration by a measured-MSE clip search
    (quant.py:179-275): on x's device, each position's per-channel maxabs
    and the int8 round-trip MSE of MSEGRID_CANDIDATES clip ratios; on the
    host in f64, per channel, the LARGEST ratio whose MSE is within (1 + tol) of
    the channel's minimum (the mildest clip inside the window). Returns the
    calibrate_folded layout: len(ops) + 1 float64 (C,) vectors.
    """
    n_cand = MSEGRID_CANDIDATES
    ratios_np = msegrid_ratios()
    x = torch.as_tensor(x, dtype=torch.float32)
    ratios = torch.as_tensor(ratios_np, dtype=torch.float32, device=x.device)
    stats = [_msegrid_stat(x, ratios)]
    darknet.apply_graph_folded(
        folded, x, ops, compute_dtype=torch.float32,
        observe=lambda h: stats.append(_msegrid_stat(h, ratios)))
    flat = torch.cat(stats).cpu().numpy().astype(np.float64)
    out, off = [], 0
    for c in _position_channels(ops, int(x.shape[-1])):
        m = np.maximum(flat[off: off + c], 1e-8)
        err = flat[off + c: off + c * (1 + n_cand)].reshape(n_cand, c)
        off += c * (1 + n_cand)
        ok = err <= err.min(axis=0) * (1.0 + tol)
        jstar = (n_cand - 1) - np.argmax(ok[::-1, :], axis=0)  # last True row
        out.append((m * ratios_np[jstar] / 127.0).astype(np.float64))
    if off != flat.size:
        raise AssertionError(f"msegrid walk gave {flat.size} values, the graph "
                             f"has {off}")
    return out


def _position_channels(ops: list[tuple], in_c: int) -> list[int]:
    """Channel count of the activation after each op, input first."""
    sizes = [in_c]
    saved: dict[str, int] = {}
    c = in_c
    for op in ops:
        kind = op[0]
        if kind == "conv":
            c = op[2]
        elif kind in ("save", "mark"):
            saved[op[1]] = c
        elif kind == "restore":
            c = saved[op[1]]
        elif kind == "concat":
            c = c + saved[op[1]]
        sizes.append(c)
    return sizes


def tail_start_index(ops: list[tuple], n_blocks: int) -> int:
    """Op index where the last `n_blocks` residual blocks begin (a "save");
    linear trunk graphs only (quant.py:296-310)."""
    if any(op[0] in ("restore", "concat") for op in ops):
        raise ValueError("bf16 tail requires a linear trunk graph")
    starts = [i for i, op in enumerate(ops) if op[0] == "save"]
    if n_blocks <= 0 or n_blocks > len(starts):
        raise ValueError(f"n_blocks must be in 1..{len(starts)}")
    return starts[-n_blocks]


def quantize_folded(folded: dict, x_calib, ops: list[tuple], *,
                    percentile: float | str | None = None,
                    bf16_tail_blocks: int = 0,
                    act_scales: list[np.ndarray] | None = None,
                    bias_correct: bool = False, bf16_ops: tuple = ()) -> dict:
    """Folded f32 params + calibration batch → int8 qparams (quant.py:313-413).

    The weight arithmetic is host numpy in f32, as in the JAX package: the
    input activation scales fold into the kernel along its input channels,
    w_scale = max(maxabs per output channel, 1e-8) / 127, kernel_q =
    clip(round_half_even(kernel / w_scale), ±127). bf16_tail_blocks keeps
    the last N residual blocks (and what follows) in folded bf16;
    act_scales reuses precomputed scales; bf16_ops names convs served as
    bf16 islands. The qparams come back on the CPU (`to_device` moves them).
    bias_correct folds each conv's measured mean quantization error into
    its bias (`bias_correct_quant`); it excludes bf16_ops, as in the JAX
    package (the correction walk models an all-int8 program).
    """
    if bf16_ops and bias_correct:
        raise ValueError("bf16_ops and bias_correct are mutually exclusive")
    scales = (act_scales if act_scales is not None else
              calibrate_folded(folded, x_calib, ops, percentile=percentile))
    tail_start = (tail_start_index(ops, bf16_tail_blocks)
                  if bf16_tail_blocks else None)

    def host(p):
        return {k: v.detach().cpu() for k, v in p.items()}

    qparams: dict = {"act_scales": scales}
    if tail_start is not None:
        qparams["tail_start"] = tail_start
        qparams["tail"] = {f"conv_{op[1]}": host(folded[f"conv_{op[1]}"])
                           for op in ops[tail_start:] if op[0] == "conv"}
    bf16_set = frozenset(int(i) for i in bf16_ops)
    if bf16_set:
        qparams["bf16_ops"] = sorted(bf16_set)
        qparams["bf16"] = {}
    cur = 0  # scales index of the running activation (= conv input position)
    for i, op in enumerate(ops):
        if tail_start is not None and i >= tail_start:
            break
        if op[0] != "conv":
            cur = i + 1
            continue
        idx = op[1]
        p = host(folded[f"conv_{idx}"])
        if idx in bf16_set:
            qparams["bf16"][f"conv_{idx}"] = p
            cur = i + 1
            continue
        kernel = p["kernel"].numpy().astype(np.float32)  # OIHW
        s_in = scales[cur].astype(np.float32)
        kernel = kernel * s_in[None, :, None, None]
        w_scale = np.maximum(np.abs(kernel).max(axis=(1, 2, 3)), 1e-8) / 127.0
        kernel_q = np.clip(np.round(kernel / w_scale[:, None, None, None]),
                           -127, 127).astype(np.int8)
        qparams[f"conv_{idx}"] = {
            "kernel_q": torch.from_numpy(
                np.ascontiguousarray(kernel_q.transpose(0, 2, 3, 1))),
            "w_scale": torch.from_numpy(w_scale.astype(np.float32)),
            "bias": p["bias"].float(),
        }
        cur = i + 1
    if "head" in folded:
        qparams["head"] = host(folded["head"])
    if bias_correct:
        qparams = bias_correct_quant(qparams, folded, x_calib, ops)
    return qparams


@torch.no_grad()
def bias_correct_quant(qparams: dict, folded: dict, x_calib, ops: list[tuple]) -> dict:
    """PTQ bias correction (quant.py:416-528): one walk of the int8 program
    beside the f32 folded one; at each conv the per-output-channel mean of
    (f32 pre-activation - int8 pre-activation) over batch and space is
    added to the int8 pre-activation at once (later layers see corrected
    predecessors) and to the conv's bias. The walk follows the served
    numerics with fuse_residual=True (a conv feeding an add requantizes
    once, at the post-add scale); with a bf16 tail it stops at the cut.

    The int8 sums are the exact ones of `conv_acc_reference` (the walk
    needs each conv's pre-requant values, which the fused kernels never
    write out). Scales, kernels and the program are unchanged; returns new
    qparams (CPU) with corrected biases.
    """
    x = torch.as_tensor(x_calib, dtype=torch.float32)
    qp = to_device(qparams, x.device)
    scale, inv = qp["act_scales_f32"], qp["act_inv_f32"]
    tail_start = qparams.get("tail_start")
    n_ops = tail_start if tail_start is not None else len(ops)
    deltas = []
    h_f = x
    h_q, s = quantize(h_f, inv[0]), 0
    saved: dict[str, tuple] = {}
    skip_add = False
    with darknet.exact_f32():
        for i, op in enumerate(ops[:n_ops]):
            kind = op[0]
            out_pos = i + 1
            if skip_add:  # consumed by the previous conv's fused epilogue
                skip_add = False
                continue
            if kind == "conv":
                _, idx, _out_c, _k, stride, _bn, act = op
                p, fp = qp[f"conv_{idx}"], folded[f"conv_{idx}"]
                acc = conv_acc_reference(h_q, p["kernel_q"], stride)
                y_q = fma_f32(acc.float(), p["w_scale"], p["bias"])
                y_f = darknet.conv_nhwc(h_f, fp["kernel"].float(), stride) + fp["bias"]
                d = torch.mean(y_f - y_q, dim=(0, 1, 2))
                deltas.append(d)
                y_q = y_q + d
                if act:
                    y_q, y_f = darknet.leaky(y_q), darknet.leaky(y_f)
                if i + 1 < n_ops and ops[i + 1][0] == "add":
                    sq, spos, sf = saved[ops[i + 1][1]]
                    y_q = fma_f32(sq.float(), scale[spos], y_q)
                    y_f = y_f + sf
                    out_pos, skip_add = i + 2, True  # post-add position's scale
                h_q, s, h_f = quantize(y_q, inv[out_pos]), out_pos, y_f
            elif kind in ("save", "mark"):
                saved[op[1]] = (h_q, s, h_f)
            elif kind == "add":
                sq, spos, sf = saved[op[1]]
                y = sq.float() * scale[spos] + h_q.float() * scale[s]
                h_q, s, h_f = quantize(y, inv[out_pos]), out_pos, sf + h_f
            elif kind == "restore":
                h_q, s, h_f = saved[op[1]]
            elif kind == "concat":
                sq, spos, sf = saved[op[1]]
                y = torch.cat([h_q.float() * scale[s], sq.float() * scale[spos]], dim=-1)
                h_q, s = quantize(y, inv[out_pos]), out_pos
                h_f = torch.cat([h_f, sf], dim=-1)
            elif kind == "upsample":
                h_q = h_q.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                h_f = h_f.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            elif kind == "output":
                pass
            else:
                raise ValueError(f"unknown op {op}")
    flat = torch.cat(deltas).cpu().numpy() if deltas else np.zeros(0, np.float32)
    out = dict(qparams)
    off = 0
    for op in ops[:n_ops]:
        if op[0] != "conv":
            continue
        idx, out_c = op[1], op[2]
        entry = dict(out[f"conv_{idx}"])
        entry["bias"] = entry["bias"].cpu().float() + torch.from_numpy(
            flat[off:off + out_c].astype(np.float32))
        out[f"conv_{idx}"] = entry
        off += out_c
    if off != flat.size:
        raise AssertionError(f"bias correction measured {flat.size} channels, "
                             f"the walk has {off}")
    return out


@torch.no_grad()
def int8_error_profile(qparams: dict, folded: dict, x, ops: list[tuple]) -> dict[int, float]:
    """Per-conv relative error of the int8 walk vs the f32 folded twin
    (quant.py:529-640): the damage localiser behind bf16 islands (bf16_ops).

    One walk of the deployed int8 program beside the f32 folded forward, as
    `bias_correct_quant`'s, records at every int8 conv the post-epilogue
    (pre-requant) relative error ||y_q - y_f|| / ||y_f|| over batch, space
    and channels. The post-epilogue values come from `conv_acc_reference`'s
    exact sums (the kernels never write them out); the next layer's int8
    input is their requantization, which is what serving's `conv_int8`
    writes (its epilogue is `requant_reference`'s, bit for bit), so the walk
    launches no kernel. With a bf16 tail the walk stops at the cut (a tail_start of 0
    profiles nothing); bf16-island convs run their folded f32 conv on the
    dequantized input and get no row. Returns {conv_idx: rel_err} in op
    order.
    """
    tail_start = qparams.get("tail_start")
    n_ops = len(ops) if tail_start is None else tail_start
    island = {op[1] for op in ops[:n_ops]
              if op[0] == "conv" and f"conv_{op[1]}" not in qparams}
    if not any(op[0] == "conv" and op[1] not in island for op in ops[:n_ops]):
        return {}
    x = torch.as_tensor(x, dtype=torch.float32)
    qp = to_device(qparams, x.device)
    scale, inv = qp["act_scales_f32"], qp["act_inv_f32"]
    errs: dict[int, torch.Tensor] = {}
    h_f = x
    h_q, s = quantize(h_f, inv[0]), 0
    saved: dict[str, tuple] = {}
    skip_add = False
    with darknet.exact_f32():
        for i, op in enumerate(ops[:n_ops]):
            kind = op[0]
            out_pos = i + 1
            if skip_add:  # consumed by the previous conv's fused epilogue
                skip_add = False
                continue
            if kind == "conv":
                _, idx, _out_c, _k, stride, _bn, act = op
                fp = folded[f"conv_{idx}"]
                y_f = darknet.conv_nhwc(h_f, fp["kernel"].float(), stride) + fp["bias"]
                skip_q = skip_s = None
                if i + 1 < n_ops and ops[i + 1][0] == "add":
                    skip_q, spos, sf = saved[ops[i + 1][1]]
                    skip_s = scale[spos]
                    out_pos, skip_add = i + 2, True  # post-add position's scale
                if idx in island:
                    y_q = darknet.conv_nhwc(h_q.float() * scale[s], fp["kernel"].float(),
                                            stride) + fp["bias"]
                else:
                    p = qp[f"conv_{idx}"]
                    acc = conv_acc_reference(h_q, p["kernel_q"], stride)
                    y_q = fma_f32(acc.float(), p["w_scale"], p["bias"])
                if act:
                    y_q, y_f = darknet.leaky(y_q), darknet.leaky(y_f)
                if skip_q is not None:
                    y_q = fma_f32(skip_q.float(), skip_s, y_q)
                    y_f = y_f + sf
                if idx not in island:
                    errs[idx] = torch.sqrt(torch.mean(torch.square(y_q - y_f))
                                           / (torch.mean(torch.square(y_f)) + 1e-12))
                h_q, s, h_f = quantize(y_q, inv[out_pos]), out_pos, y_f
            elif kind in ("save", "mark"):
                saved[op[1]] = (h_q, s, h_f)
            elif kind == "add":
                sq, spos, sf = saved[op[1]]
                y = sq.float() * scale[spos] + h_q.float() * scale[s]
                h_q, s, h_f = quantize(y, inv[out_pos]), out_pos, sf + h_f
            elif kind == "restore":
                h_q, s, h_f = saved[op[1]]
            elif kind == "concat":
                sq, spos, sf = saved[op[1]]
                y = torch.cat([h_q.float() * scale[s], sq.float() * scale[spos]], dim=-1)
                h_q, s = quantize(y, inv[out_pos]), out_pos
                h_f = torch.cat([h_f, sf], dim=-1)
            elif kind == "upsample":
                h_q = h_q.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                h_f = h_f.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            elif kind == "output":
                pass
            else:
                raise ValueError(f"unknown op {op}")
    vals = torch.stack(list(errs.values())).double().cpu().tolist()
    return dict(zip(errs, vals))


def to_device(qparams: dict, device) -> dict:
    """qparams with every tensor on `device`, plus "act_scales_f32" and
    "act_inv_f32": the per-position scale vectors as f32 and their inverses
    taken in float64 and then cast to f32 (quant.py:679, :795-796).
    qparams that an earlier call already put on `device` come back as they
    are."""
    device = torch.device(device)
    inv = qparams.get("act_inv_f32")
    if inv is not None and inv[0].device == device:
        return qparams
    out: dict = {}
    for name, v in qparams.items():
        if name in ("tail", "bf16"):
            out[name] = {c: {k: t.to(device) for k, t in p.items()}
                         for c, p in v.items()}
        elif name.startswith("conv_") or name in ("head", "dense1"):
            out[name] = {k: t.to(device) for k, t in v.items()}
        elif name not in ("act_scales_f32", "act_inv_f32"):
            out[name] = v
    scales = [np.asarray(s, np.float64) for s in qparams["act_scales"]]
    flat = np.concatenate([np.concatenate([s.astype(np.float32) for s in scales]),
                           np.concatenate([(1.0 / s).astype(np.float32)
                                           for s in scales])])
    dev = torch.from_numpy(flat).to(device)
    sizes = [s.size for s in scales]
    n = sum(sizes)
    # Separate tensors, not views of one buffer: torch.export.save keeps a
    # program's constants by storage, and views of one are not kept apart.
    out["act_scales_f32"] = [t.clone() for t in torch.split(dev[:n], sizes)]
    out["act_inv_f32"] = [t.clone() for t in torch.split(dev[n:], sizes)]
    return out


def _block_match(ops: list[tuple], i: int, in_c: int) -> bool:
    """ops[i] is a 'save': does a fusable residual block start here?
    save → conv 1x1 s1 leaky → conv 3x3 s1 leaky back to in_c → add(same
    name), both channel counts 128-multiples (quant.py:645-663)."""
    if i + 3 >= len(ops):
        return False
    c1, c2 = ops[i + 1], ops[i + 2]
    return (
        c1[0] == "conv" and c2[0] == "conv"
        and ops[i + 3] == ("add", ops[i][1])
        and c1[3] == 1 and c1[4] == 1 and c1[6]
        and c2[3] == 3 and c2[4] == 1 and c2[6]
        and c2[2] == in_c
        and block_eligible(in_c, c1[2])
    )


def apply_graph_quant(qparams: dict, x: torch.Tensor, ops: list[tuple], *,
                      fuse_residual: bool = True,
                      fused_blocks: bool = False) -> dict[str, torch.Tensor]:
    """int8 inference forward (quant.py:683-839). x: f32 NHWC network input.

    Activations travel between convs as int8 NHWC at the calibrated
    per-position scales; each conv is one `conv_int8` with its epilogue
    fused. fuse_residual folds a residual add into the epilogue of the conv
    before it (one requant, at the post-add scales). With "tail_start" the
    int8 walk stops there and the remaining ops run folded bf16; "bf16_ops"
    convs dequantize, run a bf16 conv and requantize at the same scales.
    fused_blocks runs each eligible residual block (ops/block_int8.py) as
    one kernel. Outputs are dequantized f32, as apply_graph_folded's.
    """
    qp = to_device(qparams, x.device)
    tail_start = qp.get("tail_start")
    if tail_start is not None:
        head_outs = apply_graph_quant(
            {k: v for k, v in qp.items() if k not in ("tail_start", "tail")},
            x, list(ops[:tail_start]) + [("output", "__cut")],
            fuse_residual=fuse_residual, fused_blocks=fused_blocks)
        h = head_outs.pop("__cut")
        tail_outs = darknet.apply_graph_folded(
            qp["tail"], h, list(ops[tail_start:]), compute_dtype=torch.bfloat16)
        return {**head_outs, **tail_outs}
    scale, inv = qp["act_scales_f32"], qp["act_inv_f32"]
    bf16_set = frozenset(int(i) for i in qp.get("bf16_ops", ()))
    saved: dict[str, tuple[torch.Tensor, int]] = {}
    outputs: dict[str, torch.Tensor] = {}
    h_q = quantize(x.float(), inv[0])
    s = 0  # position whose scales h_q carries
    skip_add = False  # the next op is an add already fused into a conv
    skip_until = -1  # ops consumed by a fused residual block
    for i, op in enumerate(ops):
        kind = op[0]
        if i <= skip_until:
            continue
        if skip_add:
            skip_add = False
            continue
        fuse_add = (fuse_residual and kind == "conv" and i + 1 < len(ops)
                    and ops[i + 1][0] == "add")
        if kind == "conv" and op[1] in bf16_set:
            _, idx, _out_c, _k, stride, _bn, act = op
            p = qp["bf16"][f"conv_{idx}"]
            h_f = (h_q.float() * scale[s]).to(torch.bfloat16)
            y = darknet.conv_nhwc(h_f, p["kernel"].to(torch.bfloat16), stride)
            y = y.float() + p["bias"]
            if act:
                y = darknet.leaky(y)
            out_pos = i + 1
            if fuse_add:
                skip_q, skip_pos = saved[ops[i + 1][1]]
                y = fma_f32(skip_q.float(), scale[skip_pos], y)
                out_pos, skip_add = i + 2, True
            h_q, s = quantize(y, inv[out_pos]), out_pos
            continue
        if (fused_blocks and kind == "save"
                and _block_match(ops, i, int(h_q.shape[-1]))
                and not any(ops[i + j][1] in bf16_set for j in (1, 2))):
            p1 = qp[f"conv_{ops[i + 1][1]}"]
            p2 = qp[f"conv_{ops[i + 2][1]}"]
            saved[op[1]] = (h_q, s)  # keep save semantics for later restores
            h_q = block_int8(h_q, p1["kernel_q"], p2["kernel_q"], p1["w_scale"],
                             p1["bias"], inv[i + 2], p2["w_scale"], p2["bias"],
                             scale[s], inv[i + 4])
            s, skip_until = i + 4, i + 3
            continue
        if kind == "conv":
            _, idx, _out_c, _k, stride, _bn, act = op
            p = qp[f"conv_{idx}"]
            skip_q = skip_s = None
            out_pos = i + 1
            if fuse_add:
                skip_q, skip_pos = saved[ops[i + 1][1]]
                skip_s = scale[skip_pos]
                out_pos, skip_add = i + 2, True
            h_q = conv_int8(h_q, p["kernel_q"], p["w_scale"], p["bias"],
                            inv[out_pos], stride=stride, leaky=bool(act),
                            skip_q=skip_q, skip_s=skip_s)
            s = out_pos
        elif kind in ("save", "mark"):
            saved[op[1]] = (h_q, s)
        elif kind == "add":
            # Unfused: in the whole jitted walk XLA leaves this sum of two
            # products uncontracted (the 64² trunk is bit-exact so, with
            # fuse_residual=False, under every calibration).
            skip_q, skip_pos = saved[op[1]]
            h_f = skip_q.float() * scale[skip_pos] + h_q.float() * scale[s]
            h_q, s = quantize(h_f, inv[i + 1]), i + 1
        elif kind == "restore":
            h_q, s = saved[op[1]]
        elif kind == "concat":
            skip_q, skip_pos = saved[op[1]]
            h_f = torch.cat([h_q.float() * scale[s],
                             skip_q.float() * scale[skip_pos]], dim=-1)
            h_q, s = quantize(h_f, inv[i + 1]), i + 1
        elif kind == "upsample":
            h_q = h_q.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        elif kind == "output":
            outputs[op[1]] = h_q.float() * scale[s]
        else:
            raise ValueError(f"unknown op {op}")
    return outputs


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def quantize_autotail(model, folded, x_calib, *,
                      percentile: float | str | None = None,
                      bias_correct: bool = False,
                      tails: tuple = (0, 2, 4, 5, 6, 8),
                      rel_threshold: float = 0.05,
                      improve_factor: float = 0.7, scorer=None,
                      n_scale_calib: int = 16):
    """Calibration self-check with bf16-tail escalation (quant.py:842-951).

    Quantize with each tail in `tails`, run the calibration batch through
    the int8 program and score its head against the folded-f32 head; the
    first candidate at or under `rel_threshold` wins, otherwise a larger
    tail replaces the best only when it improves the error by
    `improve_factor`. `scorer(ref_head, cand_head)` (numpy) defaults to head
    NRMSE; serving passes detection_box_f1_scorer. Scales calibrate on the
    first `n_scale_calib` images, the self-check scores all of them.
    Returns (qparams, tail_blocks, err).
    """
    ref = _host(model.apply_folded(folded, x_calib, compute_dtype=torch.float32))
    denom = float(np.sqrt(np.mean(ref.astype(np.float64) ** 2))) + 1e-12

    def default_scorer(ref_h, cand_h):
        return float(np.sqrt(np.mean(
            (np.asarray(cand_h).astype(np.float64) - ref_h) ** 2))) / denom

    score = scorer or default_scorer
    x_scale = (x_calib[:n_scale_calib]
               if n_scale_calib and x_calib is not None else x_calib)
    best = None
    for tail in tails:
        q = model.quantize(folded, x_scale, percentile=percentile,
                           bf16_tail_blocks=tail, bias_correct=bias_correct)
        err = score(ref, _host(model.apply_quant(q, x_calib)))
        # A candidate that meets the threshold wins at once; the margin only
        # arbitrates between candidates that all fail it.
        if best is None or err <= rel_threshold or err < best[2] * improve_factor:
            best = (q, tail, err)
        if best[2] <= rel_threshold:
            break
    return best


def detection_box_f1_scorer(pp_cfg, device="cpu"):
    """quantize_autotail scorer: 1 − box-level micro-F1 through the real
    postprocess (quant.py:954-1028), run on `device`.

    Each image's candidate boxes are matched greedily (best IoU first) to
    the reference boxes at IoU ≥ 0.5. When the reference detects nothing on
    the whole batch, box F1 cannot certify anything: the scorer warns, sets
    `scorer.inconclusive` and falls back to head NRMSE.
    """
    from face_vijnana_yolov3_tpu_torch.ops.boxes import pairwise_iou
    from face_vijnana_yolov3_tpu_torch.ops.postprocess import face_postprocess_batch

    def boxes_of(head):
        with torch.inference_mode():
            cands, counts = face_postprocess_batch(
                torch.as_tensor(np.asarray(head, np.float32), device=device), pp_cfg)
        return cands.cpu().numpy(), counts.cpu().numpy()

    def scorer(ref_head, cand_head):
        scorer.inconclusive = False
        rc, rn = boxes_of(ref_head)
        cc, cn = boxes_of(cand_head)
        matched = 0
        total_ref, total_cand = int(rn.sum()), int(cn.sum())
        if total_ref == 0:
            scorer.inconclusive = True
            warnings.warn(
                "detection_box_f1_scorer: f32 reference produced zero "
                "detections on the calibration batch — box-F1 is "
                "inconclusive, falling back to head NRMSE", stacklevel=2)
            ref64 = np.asarray(ref_head).astype(np.float64)
            cand64 = np.asarray(cand_head).astype(np.float64)
            denom = float(np.sqrt(np.mean(ref64 ** 2))) + 1e-12
            return float(np.sqrt(np.mean((cand64 - ref64) ** 2))) / denom
        for k in range(rc.shape[0]):
            r = rc[k, : rn[k], :4]
            c = cc[k, : cn[k], :4]
            if not len(r) or not len(c):
                continue
            iou = pairwise_iou(torch.from_numpy(r), torch.from_numpy(c)).numpy().copy()
            while iou.size and iou.max() >= 0.5:
                i, j = np.unravel_index(np.argmax(iou), iou.shape)
                matched += 1
                iou[i, :] = -1.0
                iou[:, j] = -1.0
        if total_ref + total_cand == 0:
            return 0.0
        return 1.0 - 2.0 * matched / (total_ref + total_cand)

    scorer.inconclusive = False
    return scorer
