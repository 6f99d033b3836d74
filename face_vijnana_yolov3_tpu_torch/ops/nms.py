"""Greedy IoU NMS: single-class batched over B, and multi-class.

Port of face_vijnana_yolov3_tpu/ops/nms.py (do_nms_v2 and do_nms
semantics): process boxes in descending score order; a box with score 0
never suppresses; zero the score of every later box whose IoU with a
surviving box is >= iou_th. The sort must be stable: tie order is part of
the contract (nms.py:38; jnp.argsort is stable, torch.argsort is not unless
asked). Both variants run the sweep as one `nms_sweep` launch (kernel B on
the card): the multi-class one treats each class as a row of the batch.
"""

from __future__ import annotations

import torch

from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import nms_sweep


def nms_single_class(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_th: float) -> torch.Tensor:
    """boxes (B, N, 4), scores (B, N) → (B, N) scores with suppressed entries
    zeroed, in the original box order. Invalid candidates must come in with
    score 0: they then behave exactly like boxes absent from the list."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    b_sorted = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    s_sorted = torch.gather(scores, 1, order)
    out_sorted = nms_sweep(b_sorted.contiguous(), s_sorted.contiguous(), iou_th)
    return torch.zeros_like(scores).scatter_(1, order, out_sorted)


def class_batch(boxes: torch.Tensor, class_scores: torch.Tensor):
    """boxes (N, 4), class_scores (N, C) → the sweep's (C, N) batch: each
    class's scores in stable descending order (C, N), its boxes gathered
    in that order (C, N, 4), and the order (C, N)."""
    scores = class_scores.t()
    order = torch.argsort(-scores, dim=-1, stable=True)
    return (boxes[order].contiguous(), torch.gather(scores, 1, order).contiguous(),
            order)


def nms_multi_class(boxes: torch.Tensor, class_scores: torch.Tensor,
                    iou_th: float) -> torch.Tensor:
    """boxes (N, 4), class_scores (N, C) → (N, C) class scores with the
    suppressed entries zeroed (do_nms, nms.py:53-85 of the JAX package).

    Each class is suppressed on its own: `class_batch` sorts it and gathers
    its boxes, and all C classes are swept as one (C, N) batch. The IoU of
    two gathered boxes is the JAX package's `iou[order][:, order]` entry
    for them, so the sweep sees the same matrix; the result is scattered
    back to the original order.
    """
    b_sorted, s_sorted, order = class_batch(boxes, class_scores)
    out_sorted = nms_sweep(b_sorted, s_sorted, iou_th)
    return torch.zeros_like(s_sorted).scatter_(1, order, out_sorted).t().contiguous()
