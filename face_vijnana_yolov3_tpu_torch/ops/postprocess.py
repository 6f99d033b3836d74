"""Detection post-processing: decode + NMS + candidate selection.

Port of face_vijnana_yolov3_tpu/ops/postprocess.py: the face postprocess
batched over B (:25-72; the JAX package vmaps a per-image function) and
one image's COCO postprocess (`coco_postprocess`, :77-124).
"""

from __future__ import annotations

import dataclasses

import torch

from face_vijnana_yolov3_tpu_torch.ops.decode import (
    correct_coco_boxes,
    decode_coco_scale,
    decode_face_head,
)
from face_vijnana_yolov3_tpu_torch.ops.nms import nms_multi_class, nms_single_class


@dataclasses.dataclass(frozen=True)
class FacePostprocessConfig:
    image_size: int = 416
    grid: int = 13
    conf_th: float = 0.5      # hps['face_conf_th']
    nms_iou_th: float = 0.5   # hps['nms_iou_th']
    num_cands: int = 60       # hps['num_cands']


def face_postprocess_batch(head_out: torch.Tensor, cfg: FacePostprocessConfig):
    """(B, grid, grid, 6) head → (cands (B, min(num_cands, grid²), 6),
    counts (B,) int32): `decode_face_head`, then `select_candidates`."""
    return select_candidates(
        *decode_face_head(head_out, cfg.image_size, cfg.grid, cfg.conf_th), cfg)


def select_candidates(boxes, scores, objness, mask, cfg: FacePostprocessConfig):
    """Decoded (B, N) candidates → NMS → the kept rows.

    cands rows are [xmin, ymin, xmax, ymax, objness, score] in net coords;
    rows beyond each count are zero. Survivors are ordered by score
    ASCENDING and the first num_cands kept (the reference's selection quirk,
    postprocess.py:56-65); the sort is stable like jnp.argsort. Every step
    here is exact (comparisons, sorts, gathers), so the same decode gives the
    same rows on any device.
    """
    # Invalid candidates get score 0 → behave as absent from the reference's list.
    scores = torch.where(mask, scores, 0.0)
    scores = nms_single_class(boxes, scores, cfg.nms_iou_th)

    valid = mask & (scores > 0.0)
    # get_score() clamps at 1.0: a no-op for obj*sigmoid products, kept for
    # contract fidelity.
    sort_scores = torch.clamp(scores, max=1.0)
    key = torch.where(valid, sort_scores, torch.inf)  # invalid rows sort last
    take = torch.argsort(key, dim=-1, stable=True)[:, : cfg.num_cands]
    rows = torch.cat(
        [boxes, objness[..., None], sort_scores[..., None]], dim=-1)
    rows = torch.gather(rows, 1, take[..., None].expand(-1, -1, 6))
    taken_valid = torch.gather(valid, 1, take)
    counts = taken_valid.sum(dim=-1, dtype=torch.int32)
    cands = torch.where(taken_valid[..., None], rows, 0.0)
    return cands, counts


def coco_candidates(netouts, image_h: int, image_w: int, obj_th: float = 0.5,
                    top_k: int = 256, net_h: int = 416, net_w: int = 416):
    """The COCO postprocess up to its NMS: decode the three (G, G, 255) scale
    outputs, map the boxes to original-image integer coords, keep the top_k
    candidates by gated objectness (-1 where the gate fails), and zero the
    class scores of those that fail the gate.

    `jax.lax.top_k` puts the lower index first among equal values, and with
    fewer than top_k candidates through the gate every other value is -1,
    so ties are the rule: a stable descending sort reproduces that order
    (`torch.topk` promises none).

    Returns boxes (top_k, 4), objness (top_k,), classes (top_k, 80), valid
    (top_k,) bool.
    """
    parts = [decode_coco_scale(n, s, obj_th, net_h, net_w)
             for s, n in enumerate(netouts)]
    boxes, obj, classes, mask = (torch.cat(p) for p in zip(*parts))
    boxes = correct_coco_boxes(boxes, image_h, image_w, net_h, net_w)

    gated = torch.where(mask, obj, -1.0)
    idx = torch.sort(gated, descending=True, stable=True).indices[:top_k]
    mask_k = mask[idx]
    classes_k = torch.where(mask_k[:, None], classes[idx], 0.0)
    return boxes[idx], obj[idx], classes_k, mask_k


def coco_postprocess(netouts, image_h: int, image_w: int, obj_th: float = 0.5,
                     nms_th: float = 0.45, top_k: int = 256, net_h: int = 416,
                     net_w: int = 416):
    """The COCO demo's postprocess (yolov3_detect.py:593-604) of one image:
    `coco_candidates`, then 80-class greedy NMS (one kernel launch).

    Returns boxes (top_k, 4) integer-valued f32 in original-image coords,
    objness (top_k,), classes (top_k, 80) after NMS, valid (top_k,) bool.
    """
    boxes, obj, classes, valid = coco_candidates(netouts, image_h, image_w, obj_th,
                                                 top_k, net_h, net_w)
    return boxes, obj, nms_multi_class(boxes, classes, nms_th), valid
