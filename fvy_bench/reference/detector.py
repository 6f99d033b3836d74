"""Plain PyTorch reference of the face detector's serving path, from a
frame's pixels to its rows: the strict cubic letterbox, the truncated
Darknet-53 trunk and the 3x3 head at the served precision, decode, NMS
and the un-letterbox to original coordinates.

A frozen copy of the plain twins of face_vijnana_yolov3_tpu_torch (it
imports nothing of it): ops/resize.py and ops/letterbox.py, models/
darknet.py's folded forward, models/quant.py's "auto" calibration, the
box-F1 bf16-tail ladder and the int8 walk, ops/conv_int8.py's exact sums
and fused epilogue, ops/decode.py, ops/nms.py with the plain sweep, and
ops/postprocess.py. The int8 residual blocks run as their two convs, which
is what the fused kernel computes. The graph is built from the
configuration file. Everything the program derives from the weights and
the frames (folded kernels, scales, the chosen tail, letterbox matrices)
is worked out again here.

`qmax` is the largest quantized magnitude: 127 is int8; the control runs
7 (int4). `fp8` rounds each bf16 conv's operands through per-tensor scaled
float8 e4m3 (the control of bf16 serving).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
LEAKY_ALPHA = 0.1
AUTO_PERCENTILES = (99.99, 99.9)
AUTO_MARGIN = 0.3
LADDER = (0, 2, 4, 5, 6, 8)
LADDER_THRESHOLD = 0.05
LADDER_IMPROVE = 0.7
CALIB_SCALE_IMAGES = 16
CALIB_IMAGES = 32
FP8_MAX = 448.0


# ------------------------------------------------------------------ graph

def trunk_ops(arch: dict) -> list[tuple]:
    """The trunk's op list (conv, save, add, output) from the
    configuration's "trunk" entries: ["conv", out_c, k, stride] or
    ["res", n_blocks, c_half, c_full], conv indices numbered as the
    reference's Keras layers (a residual block's add takes an index)."""
    ops: list[tuple] = []
    idx = 0
    for entry in arch["trunk"]:
        if entry[0] == "conv":
            ops.append(("conv", idx, entry[1], entry[2], entry[3], True, True))
            idx += 1
        else:
            _, n_blocks, c_half, c_full = entry
            for _ in range(n_blocks):
                ops.append(("save", "skip"))
                ops.append(("conv", idx, c_half, 1, 1, True, True))
                ops.append(("conv", idx + 1, c_full, 3, 1, True, True))
                ops.append(("add", "skip"))
                idx += 3
    ops.append(("output", "trunk"))
    return ops


@contextlib.contextmanager
def exact_f32():
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def leaky(h):
    return torch.where(h > 0, h, LEAKY_ALPHA * h)


def conv_nhwc(h, kernel, stride):
    k = kernel.shape[-1]
    return F.conv2d(h.permute(0, 3, 1, 2), kernel, stride=stride,
                    padding=k // 2).permute(0, 2, 3, 1)


def fold(sd: dict, ops: list[tuple]) -> dict:
    """Conv + eval BatchNorm folded: scale = gamma / sqrt(var + eps) (the
    square root taken in f64), kernel * scale, beta - mean * scale."""
    folded = {}
    for op in ops:
        if op[0] != "conv":
            continue
        i = op[1]
        scale = sd[f"bnorm_{i}.gamma"] / torch.sqrt(
            (sd[f"bnorm_{i}.var"] + BN_EPS).double()).float()
        folded[f"conv_{i}"] = {"kernel": sd[f"conv_{i}.weight"] * scale[:, None, None, None],
                               "bias": sd[f"bnorm_{i}.beta"] - sd[f"bnorm_{i}.mean"] * scale}
    if "head.weight" in sd:
        folded["head"] = {"kernel": sd["head.weight"].clone(), "bias": sd["head.bias"].clone()}
    return folded


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded through float8 e4m3 at one per-tensor scale, back in t's dtype."""
    s = torch.clamp_min(t.detach().abs().amax().float(), 1e-12) / FP8_MAX
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)


def apply_folded(folded, x, ops, *, dtype=torch.bfloat16, f32_front_ops=0,
                 observe=None, fp8=False):
    """Folded forward, NHWC: each conv in `dtype` (ops before
    f32_front_ops in f32), + f32 bias, leaky, cast back; f32 outputs."""
    saved, outputs, h = {}, {}, x
    with exact_f32():
        for i, op in enumerate(ops):
            kind = op[0]
            op_dtype = torch.float32 if i < f32_front_ops else dtype
            if kind == "conv":
                _, idx, _c, _k, stride, _bn, act = op
                p = folded[f"conv_{idx}"]
                a, w = h.to(op_dtype), p["kernel"].to(op_dtype)
                if fp8 and op_dtype != torch.float32:
                    a, w = _fp8(a), _fp8(w)
                h = conv_nhwc(a, w, stride) + p["bias"]
                if act:
                    h = leaky(h)
                h = h.to(op_dtype)
            elif kind in ("save", "mark"):
                saved[op[1]] = h
            elif kind == "add":
                h = saved[op[1]] + h
            elif kind == "output":
                outputs[op[1]] = h.float()
            if observe is not None:
                observe(h)
    return outputs


def head(feat, p, dtype, fp8=False):
    a, w = feat.to(dtype), p["kernel"].to(dtype)
    if fp8 and dtype != torch.float32:
        a, w = _fp8(a), _fp8(w)
    with exact_f32():
        h = conv_nhwc(a, w, 1)
    return (h + p["bias"]).float()


def front_end_index(ops, n_blocks):
    return [i for i, op in enumerate(ops) if op[0] == "save"][n_blocks - 1]


# ------------------------------------------------------------------ int8

def fma_f32(a, b, c):
    """f32 a * b + c rounded once (round-to-odd in f64, then to f32)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(inexact_even, torch.nextafter(s, toward), s).float()


def quantize(h, inv, qmax):
    return torch.round(h * inv).clamp_(-qmax, qmax).to(torch.int8)


def conv_acc(x_q, w_q, stride):
    """Exact integer sums of an NHWC int8 conv (OHWI weights), in f64."""
    k = w_q.shape[1]
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x_q.permute(0, 3, 1, 2).double(), w_q.permute(0, 3, 1, 2).double(),
                       stride=stride, padding=k // 2)
    return acc.permute(0, 2, 3, 1)


def _percentiles(a, percentiles):
    n = a.shape[0]
    q = torch.tensor(percentiles, dtype=torch.float32, device=a.device) / 100
    pos = q * (torch.tensor(float(n), dtype=torch.float32, device=a.device) - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    low_i = low.clamp(0, n - 1).long()
    high_i = high.clamp(0, n - 1).long()
    top = torch.topk(a.t(), n - int(low_i.min()), dim=1).values.t()
    return top[n - 1 - low_i] * low_w[:, None] + top[n - 1 - high_i] * high_w[:, None]


def _auto_stat(h, qmax):
    """Per channel: maxabs, unless a clip percentile cuts the round-trip
    MSE below AUTO_MARGIN of maxabs's."""
    a = h.abs().reshape(-1, h.shape[-1]).float()
    cands = torch.cat([a.amax(dim=0, keepdim=True), _percentiles(a, AUTO_PERCENTILES)])
    s = torch.clamp_min(cands, 1e-8) * float(np.float32(1.0) / np.float32(qmax))
    err = torch.stack([torch.mean(torch.square(
        torch.round(a / s[j]).clamp(-qmax, qmax) * s[j] - a), dim=0)
        for j in range(cands.shape[0])])
    best = torch.argmin(err[1:], dim=0) + 1
    pick = torch.where(torch.gather(err, 0, best[None])[0] < AUTO_MARGIN * err[0], best, 0)
    return torch.gather(cands, 0, pick[None])[0]


def _channels(ops, in_c):
    sizes, saved, c = [in_c], {}, in_c
    for op in ops:
        if op[0] == "conv":
            c = op[2]
        elif op[0] in ("save", "mark"):
            saved[op[1]] = c
        sizes.append(c)
    return sizes


def calibrate(folded, x, ops, qmax):
    """Per-position per-channel activation scales (f64 numpy), entry 0 the
    input's, from an f32 folded walk with "auto" statistics."""
    stats = [_auto_stat(x, qmax)]
    apply_folded(folded, x, ops, dtype=torch.float32,
                 observe=lambda h: stats.append(_auto_stat(h, qmax)))
    flat = torch.cat(stats).cpu().numpy().astype(np.float64)
    out, off = [], 0
    for c in _channels(ops, int(x.shape[-1])):
        out.append(np.maximum(flat[off:off + c], 1e-8) / float(qmax))
        off += c
    return out


def quantize_folded(folded, scales, ops, tail_blocks, qmax):
    """Weights quantized per output channel with the input scales folded
    in (host numpy f32); with a tail, the last blocks stay folded bf16."""
    starts = [i for i, op in enumerate(ops) if op[0] == "save"]
    tail_start = starts[-tail_blocks] if tail_blocks else None
    q = {"scales": scales, "tail_start": tail_start, "head": folded.get("head"),
         "tail": folded}
    cur = 0
    for i, op in enumerate(ops):
        if tail_start is not None and i >= tail_start:
            break
        if op[0] != "conv":
            cur = i + 1
            continue
        p = folded[f"conv_{op[1]}"]
        kernel = p["kernel"].detach().cpu().numpy().astype(np.float32)
        kernel = kernel * scales[cur].astype(np.float32)[None, :, None, None]
        w_scale = np.maximum(np.abs(kernel).max(axis=(1, 2, 3)), 1e-8) / float(qmax)
        kq = np.clip(np.round(kernel / w_scale[:, None, None, None]), -qmax, qmax)
        dev = p["kernel"].device
        q[f"conv_{op[1]}"] = {
            "kernel_q": torch.from_numpy(np.ascontiguousarray(
                kq.astype(np.int8).transpose(0, 2, 3, 1))).to(dev),
            "w_scale": torch.from_numpy(w_scale.astype(np.float32)).to(dev),
            "bias": p["bias"].float()}
        cur = i + 1
    dev = folded["conv_0"]["kernel"].device
    q["scale_f32"] = [torch.from_numpy(s.astype(np.float32)).to(dev) for s in scales]
    q["inv_f32"] = [torch.from_numpy((1.0 / s).astype(np.float32)).to(dev) for s in scales]
    return q


def apply_quant(q, x, ops, qmax):
    """The int8 walk with fused residuals; a tail runs folded bf16."""
    tail_start = q["tail_start"]
    walk = ops if tail_start is None else list(ops[:tail_start]) + [("output", "__cut")]
    scale, inv = q["scale_f32"], q["inv_f32"]
    saved, outputs = {}, {}
    h_q, s, skip_add = quantize(x.float(), inv[0], qmax), 0, False
    for i, op in enumerate(walk):
        kind = op[0]
        if skip_add:
            skip_add = False
            continue
        if kind == "conv":
            _, idx, _c, _k, stride, _bn, act = op
            p = q[f"conv_{idx}"]
            h = fma_f32(conv_acc(h_q, p["kernel_q"], stride).float(), p["w_scale"], p["bias"])
            if act:
                h = leaky(h)
            out_pos = i + 1
            if i + 1 < len(walk) and walk[i + 1][0] == "add":
                sq, spos = saved[walk[i + 1][1]]
                h = fma_f32(sq.float(), scale[spos], h)
                out_pos, skip_add = i + 2, True
            h_q, s = quantize(h, inv[out_pos], qmax), out_pos
        elif kind in ("save", "mark"):
            saved[op[1]] = (h_q, s)
        elif kind == "output":
            outputs[op[1]] = h_q.float() * scale[s]
    if tail_start is None:
        return outputs["trunk"]
    tail = apply_folded(q["tail"], outputs["__cut"], list(ops[tail_start:]),
                        dtype=torch.bfloat16)
    return tail["trunk"]


# ------------------------------------------------------------------ postprocess

@dataclasses.dataclass(frozen=True)
class Post:
    image_size: int
    grid: int
    conf_th: float
    iou_th: float
    num_cands: int


def _to_int32(x):
    return torch.nan_to_num(x, nan=0.0).to(torch.int32)


def decode(t, pp: Post):
    cell, g, s = pp.image_size // pp.grid, pp.grid, pp.image_size
    t = t.float()
    obj = 1.0 / (1.0 + torch.exp(-t[..., 0]))
    score = obj * (1.0 / (1.0 + torch.exp(-t[..., 5])))
    b = torch.clamp(t[..., 1:5], min=0.0)
    rows = torch.arange(g, dtype=torch.int32, device=t.device)[:, None]
    cols = torch.arange(g, dtype=torch.int32, device=t.device)[None, :]
    px = _to_int32(torch.clamp(torch.floor(b[..., 0] * cell), max=cell - 1)) + cell * cols
    py = _to_int32(torch.clamp(torch.floor(b[..., 1] * cell), max=cell - 1)) + cell * rows
    half_w = _to_int32(torch.floor(torch.clamp(b[..., 2] * s, max=float(s)) / 2.0))
    half_h = _to_int32(torch.floor(torch.clamp(b[..., 3] * s, max=float(s)) / 2.0))
    boxes = torch.stack([torch.clamp(px - half_w, min=0), torch.clamp(py - half_h, min=0),
                         torch.clamp(px + half_w, max=s - 1),
                         torch.clamp(py + half_h, max=s - 1)], -1).float()
    n = t.shape[0]
    return (boxes.reshape(n, -1, 4), score.reshape(n, -1), obj.reshape(n, -1),
            ((obj > 0.0) & (score >= pp.conf_th)).reshape(n, -1))


def pairwise_iou(a, b):
    a, b = a[..., :, None, :], b[..., None, :, :]
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]),
                     min=0.0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]),
                     min=0.0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter)


def postprocess(head_out, pp: Post):
    """(B, g, g, 6) head → (cands (B, num_cands, 6), counts (B,)): decode,
    greedy NMS in stable descending score order, survivors by ascending
    score (the reference's selection), the first num_cands kept."""
    boxes, scores, objness, mask = decode(head_out, pp)
    scores = torch.where(mask, scores, 0.0)
    order = torch.argsort(-scores, dim=-1, stable=True)
    bs = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    ss = torch.gather(scores, 1, order)
    iou = pairwise_iou(bs, bs)
    idx = torch.arange(ss.shape[-1], device=ss.device)
    for i in range(ss.shape[-1]):
        kill = (ss[:, i:i + 1] > 0.0) & (idx > i) & (iou[:, i] >= pp.iou_th)
        ss = torch.where(kill, 0.0, ss)
    scores = torch.zeros_like(scores).scatter_(1, order, ss)
    valid = mask & (scores > 0.0)
    sort_scores = torch.clamp(scores, max=1.0)
    take = torch.argsort(torch.where(valid, sort_scores, torch.inf), dim=-1,
                         stable=True)[:, :pp.num_cands]
    rows = torch.cat([boxes, objness[..., None], sort_scores[..., None]], dim=-1)
    rows = torch.gather(rows, 1, take[..., None].expand(-1, -1, 6))
    tv = torch.gather(valid, 1, take)
    return torch.where(tv[..., None], rows, 0.0), tv.sum(dim=-1, dtype=torch.int32)


# ------------------------------------------------------------------ letterbox

@dataclasses.dataclass(frozen=True)
class Geometry:
    src_h: int
    src_w: int
    new_h: int
    new_w: int
    pad_t: int
    pad_l: int


def geometry(h: int, w: int, s: int) -> Geometry:
    if w >= h:
        new_h = int(h / w * s)
        return Geometry(h, w, new_h, s, (s - new_h) // 2, 0)
    new_w = int(w / h * s)
    return Geometry(h, w, s, new_w, 0, (s - new_w) // 2)


def _cubic(t, a=-0.75):
    d = np.stack([1.0 + t, t, 1.0 - t, 2.0 - t], axis=-1)
    ad = np.abs(d)
    near = ((a + 2.0) * ad - (a + 3.0)) * ad * ad + 1.0
    far = a * (((ad - 5.0) * ad + 8.0) * ad - 4.0)
    return np.where(ad <= 1.0, near, np.where(ad < 2.0, far, 0.0))


def resize_matrix(src: int, new: int, pad: int, s: int) -> np.ndarray:
    """(s, src) f32 cv2-cubic resize of src → new into rows [pad, pad + new)."""
    x = (np.arange(new) + 0.5) * (src / new) - 0.5
    x0 = np.floor(x)
    idx = np.clip(x0[:, None].astype(np.int64) + np.arange(-1, 3)[None, :], 0, src - 1)
    w = _cubic(x - x0).astype(np.float32)
    m = np.zeros((s, src), np.float32)
    np.add.at(m, (pad + np.arange(new)[:, None], idx), w)
    return m


def letterbox(frames_u8: torch.Tensor, g: Geometry, s: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 frames of one geometry → (B, s, s, 3) f32: pixels
    * (1/255), the rows pass, then the cols pass, TF32 off."""
    dev = frames_u8.device
    rm = torch.from_numpy(resize_matrix(g.src_h, g.new_h, g.pad_t, s)).to(dev)
    cm = torch.from_numpy(resize_matrix(g.src_w, g.new_w, g.pad_l, s)).to(dev)
    x = frames_u8.to(torch.float32) * (1.0 / 255.0)
    b, h, w, c = x.shape
    with exact_f32():
        tmp = torch.matmul(rm, x.reshape(b, h, w * c)).reshape(b, s, w, c)
        out = torch.matmul(cm, tmp.permute(2, 0, 1, 3).reshape(w, b * s * c))
    return out.reshape(s, b, s, c).permute(1, 2, 0, 3).contiguous()


def unletterbox(cands: np.ndarray, g: Geometry, s: int) -> np.ndarray:
    """(B, N, >=4) net-coordinate rows → original coordinates, f64."""
    b = np.asarray(cands[..., :4], np.float64)
    w, h = float(g.src_w), float(g.src_h)
    out = np.empty_like(b)
    if w >= h:
        out[..., 0::2] = np.minimum(b[..., 0::2] * w / s, w)
        out[..., 1::2] = np.minimum(np.maximum(b[..., 1::2] - g.pad_t, 0) * w / s, h)
    else:
        out[..., 0::2] = np.minimum(np.maximum(b[..., 0::2] - g.pad_l, 0) * h / s, w)
        out[..., 1::2] = np.minimum(b[..., 1::2] * h / s, h)
    return out


# ------------------------------------------------------------------ the detector

class Detector:
    """The served detector of one configuration, precision and set of
    weights. int8 calibrates on the first frames it is given
    (`calibrate`), as the program calibrates on its first chunk."""

    def __init__(self, arch: dict, sd: dict, precision: str, *, qmax: int = 127,
                 fp8: bool = False, bf16_f32_front: int = 2):
        self.arch, self.precision, self.qmax, self.fp8 = arch, precision, qmax, fp8
        self.s = arch["image_size"]
        self.ops = trunk_ops(arch)
        self.folded = fold(sd, self.ops)
        self.front = (front_end_index(self.ops, bf16_f32_front) if bf16_f32_front else 0)
        self.pp = Post(self.s, self.s // 32, arch["face_conf_th"], arch["nms_iou_th"],
                       arch["num_cands"])
        self.q = None
        self.tail = None

    def _heads_int8(self, q, x):
        return head(apply_quant(q, x, self.ops, self.qmax), q["head"], torch.bfloat16)

    def calibrate(self, frames_u8: torch.Tensor):
        """Scales on the first 16 letterboxed frames, the tail ladder scored
        by box F1 against the folded f32 head on the first 32."""
        x = letterbox(frames_u8[:CALIB_IMAGES], geometry(*frames_u8.shape[1:3], self.s),
                      self.s)
        ref = head(apply_folded(self.folded, x, self.ops, dtype=torch.float32)["trunk"],
                   self.folded["head"], torch.float32)
        scales = calibrate(self.folded, x[:CALIB_SCALE_IMAGES], self.ops, self.qmax)
        best = None
        for tail in LADDER:
            q = quantize_folded(self.folded, scales, self.ops, tail, self.qmax)
            err = self._box_f1_error(ref, self._heads_int8(q, x))
            if best is None or err <= LADDER_THRESHOLD or err < best[2] * LADDER_IMPROVE:
                best = (q, tail, err)
            if best[2] <= LADDER_THRESHOLD:
                break
        self.q, self.tail, self.calib_err = best

    def _box_f1_error(self, ref_head, cand_head) -> float:
        rc, rn = (t.cpu().numpy() for t in postprocess(ref_head, self.pp))
        cc, cn = (t.cpu().numpy() for t in postprocess(cand_head, self.pp))
        total = int(rn.sum()) + int(cn.sum())
        if int(rn.sum()) == 0:
            r64, c64 = ref_head.double(), cand_head.double()
            denom = float(torch.sqrt(torch.mean(r64 ** 2))) + 1e-12
            return float(torch.sqrt(torch.mean((c64 - r64) ** 2))) / denom
        matched = 0
        for k in range(rc.shape[0]):
            r, c = rc[k, :rn[k], :4], cc[k, :cn[k], :4]
            if len(r) and len(c):
                matched += greedy_matches(r, c, np.ones(len(r)), np.ones(len(c)), np.inf)
        return 1.0 - 2.0 * matched / total if total else 0.0

    @torch.no_grad()
    def heads(self, frames_u8: torch.Tensor) -> torch.Tensor:
        x = letterbox(frames_u8, geometry(*frames_u8.shape[1:3], self.s), self.s)
        if self.precision == "int8":
            return self._heads_int8(self.q, x)
        if self.precision == "bfloat16":
            trunk = apply_folded(self.folded, x, self.ops, dtype=torch.bfloat16,
                                 f32_front_ops=self.front, fp8=self.fp8)["trunk"]
            return head(trunk, self.folded["head"], torch.bfloat16, fp8=self.fp8)
        trunk = apply_folded(self.folded, x, self.ops, dtype=torch.float32)["trunk"]
        return head(trunk, self.folded["head"], torch.float32)

    @torch.no_grad()
    def rows(self, frames_u8: torch.Tensor) -> list[np.ndarray]:
        """Each frame's rows [xmin, ymin, xmax, ymax, score] in original
        coordinates, as the program's serving loop writes them."""
        cands, counts = (t.cpu().numpy() for t in postprocess(self.heads(frames_u8), self.pp))
        ub = unletterbox(cands, geometry(*frames_u8.shape[1:3], self.s), self.s)
        sc = cands[..., 5].astype(np.float64)
        return [np.concatenate([ub[k, :n], sc[k, :n, None]], 1) for k, n in enumerate(counts)]


def greedy_matches(r: np.ndarray, c: np.ndarray, rs: np.ndarray, cs: np.ndarray,
                   score_tol: float, iou_th: float = 0.5) -> int:
    """Pairs of rows matched greedily, best IoU first, at IoU >= iou_th and
    scores within score_tol; the IoU in the rows' own dtype."""
    iou = pairwise_iou(torch.from_numpy(np.asarray(r)),
                       torch.from_numpy(np.asarray(c))).numpy().copy()
    iou[np.abs(rs[:, None] - cs[None, :]) > score_tol] = -1.0
    iou = np.nan_to_num(iou, nan=-1.0)
    n = 0
    while iou.size and iou.max() >= iou_th:
        i, j = np.unravel_index(np.argmax(iou), iou.shape)
        n += 1
        iou[i, :] = -1.0
        iou[:, j] = -1.0
    return n
