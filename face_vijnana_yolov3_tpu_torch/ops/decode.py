"""YOLO head decoding as fixed-shape tensor ops.

Port of face_vijnana_yolov3_tpu/ops/decode.py: the face head batched over B
(`decode_face_head`, :16-75) and one image's COCO scale (`decode_coco_scale`,
`correct_coco_boxes`, :80-162).

The COCO half follows the JAX package's jitted program, which is the one its
demo runs: XLA folds a division by a constant into a multiplication by the
constant's f32 reciprocal, and a product of two constants into one, so
`x / grid` is `x * f32(1/grid)` there and `(b - off) / scale * image_w` is
`(b - off) * f32(f32(1/scale) * image_w)` (`_recip`, `_fold`). Eager JAX
divides and differs in the last bit on about a third of the values. XLA's
CPU backend also contracts one product of `x ± w/2` into an FMA, a
different one per scale's fusion; the port does not chase that choice, so
decoded corners agree with the jitted program within rounding and the
truncated pixel boxes almost always exactly (tests/test_torch_coco.py).
"""

from __future__ import annotations

import numpy as np
import torch


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """f32 → int32 as XLA converts it: NaN → 0. torch's own cast of NaN is
    INT_MIN on the CPU and 0 on the card; the operands here are otherwise in
    range (min-clamped below, or at most image_size)."""
    return torch.nan_to_num(x, nan=0.0).to(torch.int32)


def decode_face_head(
    head_out: torch.Tensor,
    image_size: int = 416,
    grid: int = 13,
    conf_th: float = 0.5,
):
    """Decode a (B, grid, grid, 6) face head into fixed-shape candidates.

    Same math as the JAX decode (obj = sigmoid(ch0), score = obj *
    sigmoid(ch5); gate obj > 0 and score >= conf_th; coords clamped at 0;
    floor-then-int32 truncations, then the clamps, decode.py:56-66).

    Returns boxes (B, grid², 4) integer-valued f32 [xmin, ymin, xmax, ymax] in
    net coords, scores (B, grid²), objness (B, grid²), mask (B, grid²) bool.
    """
    cell = image_size // grid
    t = head_out.to(torch.float32)
    batch = t.shape[0]
    obj = 1.0 / (1.0 + torch.exp(-t[..., 0]))
    score = obj * (1.0 / (1.0 + torch.exp(-t[..., 5])))
    b = torch.clamp(t[..., 1:5], min=0.0)

    rows = torch.arange(grid, dtype=torch.int32, device=t.device)[:, None]
    cols = torch.arange(grid, dtype=torch.int32, device=t.device)[None, :]

    px = _to_int32(torch.clamp(torch.floor(b[..., 0] * cell), max=cell - 1)) + cell * cols
    py = _to_int32(torch.clamp(torch.floor(b[..., 1] * cell), max=cell - 1)) + cell * rows
    pw = torch.clamp(b[..., 2] * image_size, max=float(image_size))
    ph = torch.clamp(b[..., 3] * image_size, max=float(image_size))
    half_w = _to_int32(torch.floor(pw / 2.0))
    half_h = _to_int32(torch.floor(ph / 2.0))

    xmin = torch.clamp(px - half_w, min=0)
    ymin = torch.clamp(py - half_h, min=0)
    xmax = torch.clamp(px + half_w, max=image_size - 1)
    ymax = torch.clamp(py + half_h, max=image_size - 1)

    mask = (obj > 0.0) & (score >= conf_th)

    boxes = torch.stack([xmin, ymin, xmax, ymax], dim=-1).to(torch.float32)
    return (boxes.reshape(batch, -1, 4), score.reshape(batch, -1),
            obj.reshape(batch, -1), mask.reshape(batch, -1))


# Anchor table and the per-scale anchor-subset skip quirk of the reference
# (yolov3_detect.py:354-362): at scale 0 only b==1 survives, at scale 1 b==0 and
# b==2, at scale 2 only b==1.
COCO_ANCHORS = (
    (116, 90, 156, 198, 373, 326),
    (30, 61, 62, 45, 59, 119),
    (10, 13, 16, 30, 33, 23),
)
KEPT_ANCHOR_IDS = ((1,), (0, 2), (1,))


def _recip(c: float) -> float:
    """f32(1 / f32(c)): the constant XLA multiplies by for `x / c`."""
    return float(np.float32(1.0) / np.float32(c))


def _fold(scale: float, n: float) -> float:
    """f32(_recip(scale) * f32(n)): `x / scale * n` with both constants
    folded into one, as XLA's simplifier does."""
    return float(np.float32(_recip(scale)) * np.float32(n))


def decode_coco_scale(netout: torch.Tensor, scale_idx: int, obj_th: float,
                      net_h: int = 416, net_w: int = 416):
    """Decode one COCO YOLO scale (G, G, 255) into normalized candidates.

    decode_netout semantics (yolov3_detect.py:335-387): sigmoid, written
    1/(1+exp(-t)) as in the JAX package, on xy and on [obj, classes];
    exp-anchor wh; the per-scale anchor subset; gate obj >= obj_th.

    Returns boxes (G*G*K, 4) normalized [xmin, ymin, xmax, ymax] (K kept
    anchors), objness (G*G*K,), classes (G*G*K, 80), mask (G*G*K,) bool.
    """
    grid = netout.shape[0]
    anchors = COCO_ANCHORS[scale_idx]
    ids = KEPT_ANCHOR_IDS[scale_idx]
    # A strided slice (each scale keeps one id, or two), not a list: a list
    # index is a host tensor copied to the device, which a captured program
    # cannot hold.
    kept = slice(ids[0], ids[-1] + 1, ids[-1] - ids[0] or 1)
    dev = netout.device

    t = netout.reshape(grid, grid, 3, 85).to(torch.float32)
    xy = 1.0 / (1.0 + torch.exp(-t[..., 0:2]))
    obj_cls = 1.0 / (1.0 + torch.exp(-t[..., 4:]))
    obj = obj_cls[..., 0]
    classes = obj_cls[..., 1:]

    rows = torch.arange(grid, dtype=torch.float32, device=dev)[:, None, None]
    cols = torch.arange(grid, dtype=torch.float32, device=dev)[None, :, None]

    x = (cols + xy[..., 0]) * _recip(grid)
    y = (rows + xy[..., 1]) * _recip(grid)
    # Fills, not host copies (a captured program holds them).
    aw = torch.stack([t.new_full((), float(anchors[2 * b])) for b in range(3)])
    ah = torch.stack([t.new_full((), float(anchors[2 * b + 1])) for b in range(3)])
    w = aw * torch.exp(t[..., 2]) * _recip(net_w)
    h = ah * torch.exp(t[..., 3]) * _recip(net_h)

    boxes = torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)
    mask = obj >= obj_th

    boxes = boxes[:, :, kept, :].reshape(-1, 4)
    obj = obj[:, :, kept].reshape(-1)
    classes = classes[:, :, kept, :].reshape(-1, 80)
    mask = mask[:, :, kept].reshape(-1)
    return boxes, obj, classes, mask


def correct_coco_boxes(boxes: torch.Tensor, image_h: int, image_w: int,
                       net_h: int = 416, net_w: int = 416) -> torch.Tensor:
    """Map normalized boxes back to original-image integer pixel coords.

    correct_yolo_boxes semantics (yolov3_detect.py:389-404): un-letterbox
    with the float geometry, including the reference's `new_h = net_w`
    (decode.py:156 of the JAX package), then truncation toward zero.
    """
    if (float(net_w) / image_w) < (float(net_h) / image_h):
        new_w = float(net_w)
        new_h = (image_h * net_w) / image_w
    else:
        new_h = float(net_w)  # reference quirk: net_w, not net_h
        new_w = (image_w * net_h) / image_h
    x_offset, x_scale = (net_w - new_w) / 2.0 / net_w, new_w / net_w
    y_offset, y_scale = (net_h - new_h) / 2.0 / net_h, new_h / net_h
    x = torch.trunc((boxes[:, 0::2] - float(np.float32(x_offset)))
                    * _fold(x_scale, image_w))
    y = torch.trunc((boxes[:, 1::2] - float(np.float32(y_offset)))
                    * _fold(y_scale, image_h))
    return torch.stack([x[:, 0], y[:, 0], x[:, 1], y[:, 1]], dim=-1)
