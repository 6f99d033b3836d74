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
  "tail_start"/"tail": with a bf16 tail, the op index where int8 stops and
                the folded params that run the rest in bf16
  "bf16_ops"/"bf16":   conv indices run as folded-bf16 islands, and theirs
`to_device` adds the device copies and the f32 scale / inverse-scale
vectors the walk uses; `apply_graph_quant` calls it.

Not ported yet (ROADMAP.md queue 1 item 6): the "msegrid" calibrator, PTQ
bias correction and distillation QAT; each raises NotImplementedError.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from face_vijnana_yolov3_tpu_torch.models import darknet
from face_vijnana_yolov3_tpu_torch.ops.block_int8 import block_eligible, block_int8
from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import conv_int8, fma_f32, quantize

# Candidate clip percentiles scored by "auto" calibration (plus exact maxabs)
# and the margin a clip must win by (quant.py:41-62).
AUTO_CALIB_PERCENTILES = (99.99, 99.9)
AUTO_CALIB_MARGIN = 0.3

NOT_PORTED = "not ported yet (ROADMAP.md queue 1 item 6)"


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


def _calib_stat(h: torch.Tensor, percentile) -> torch.Tensor:
    """Per-channel range statistic of one activation (quant.py:102-126)."""
    a = h.abs().reshape(-1, h.shape[-1]).float()
    if percentile is None:
        return a.amax(dim=0)
    if percentile == "auto":
        cands = torch.cat([a.amax(dim=0, keepdim=True),
                           _percentiles(a, AUTO_CALIB_PERCENTILES)])  # (3, C)
        s = torch.clamp_min(cands, 1e-8) / 127.0
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
    if isinstance(percentile, str) and percentile != "auto":
        raise NotImplementedError(f"int8 calibration {percentile!r}: the msegrid "
                                  f"calibrator is {NOT_PORTED}")
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
    """
    if bias_correct:
        raise NotImplementedError(f"int8 bias correction is {NOT_PORTED}")
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
    return qparams


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
        elif name.startswith("conv_") or name == "head":
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
    out["act_scales_f32"] = list(torch.split(dev[:n], sizes))
    out["act_inv_f32"] = list(torch.split(dev[n:], sizes))
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
