"""Greedy NMS suppression sweep: the CUDA kernel's wrapper and its plain twin.

`nms_sweep` is the port of face_vijnana_yolov3_tpu/ops/pallas_nms.py::
nms_sweep_pallas: boxes sorted by descending score; row i with score > 0
zeroes every later row j whose IoU(i, j) >= iou_th; NaN IoU never
suppresses. A CUDA tensor goes to the hand-written kernel in
csrc/nms_sweep.cu (one block per image: all warps build the suppression
bitmask in shared memory, then one warp scans it word by word); a CPU
tensor goes to `nms_sweep_reference`, the plain PyTorch version. There is
no fallback between the two: a CUDA call that cannot build or launch raises.
The threshold is rounded to f32 on every side (JAX and torch compare an f32
tensor with a Python float in f32; the kernel takes a `float`).
"""

from __future__ import annotations

import torch

from face_vijnana_yolov3_tpu_torch.ops.boxes import pairwise_iou

MAX_N = 1024  # csrc/nms_sweep.cu: kMaxN, 32 bitmask words a row


def nms_sweep_reference(boxes_sorted: torch.Tensor, scores_sorted: torch.Tensor,
                        iou_th: float) -> torch.Tensor:
    """Plain PyTorch sweep: (B, N, 4), (B, N) → (B, N) suppressed scores.

    One pairwise IoU matrix, then a loop over i of vectorised row
    suppressions, as ops/nms.py:42-49 of the JAX package.
    """
    n = scores_sorted.shape[-1]
    iou = pairwise_iou(boxes_sorted, boxes_sorted)  # (B, N, N)
    idx = torch.arange(n, device=scores_sorted.device)
    s = scores_sorted.clone()
    for i in range(n):
        alive = s[:, i : i + 1] > 0.0
        suppress = alive & (idx > i) & (iou[:, i] >= iou_th)
        s = torch.where(suppress, 0.0, s)
    return s


def nms_sweep(boxes_sorted: torch.Tensor, scores_sorted: torch.Tensor,
              iou_th: float) -> torch.Tensor:
    """Suppression sweep over descending-score-sorted boxes.

    boxes_sorted (B, N, 4) f32, scores_sorted (B, N) f32 (0 = absent) →
    (B, N) f32 suppressed scores in the same order.
    """
    if boxes_sorted.device.type == "cpu" and scores_sorted.device.type == "cpu":
        return nms_sweep_reference(boxes_sorted, scores_sorted, iou_th)
    if boxes_sorted.device.type != "cuda" or scores_sorted.device != boxes_sorted.device:
        raise ValueError(
            f"nms_sweep: boxes on {boxes_sorted.device} and scores on "
            f"{scores_sorted.device}; both must be on one CUDA device or the CPU")
    b, n = scores_sorted.shape
    if boxes_sorted.shape != (b, n, 4):
        raise ValueError(f"nms_sweep: boxes {tuple(boxes_sorted.shape)} do not "
                         f"match scores {tuple(scores_sorted.shape)}")
    if boxes_sorted.dtype != torch.float32 or scores_sorted.dtype != torch.float32:
        raise TypeError("nms_sweep: boxes and scores must be float32")
    if not (boxes_sorted.is_contiguous() and scores_sorted.is_contiguous()):
        raise ValueError("nms_sweep: boxes and scores must be contiguous")
    if boxes_sorted.data_ptr() % 16:
        raise ValueError("nms_sweep: boxes must be 16-byte aligned (one float4 a box)")
    if n > MAX_N:
        raise ValueError(f"nms_sweep: N={n} exceeds the kernel's {MAX_N}")
    if b == 0 or n == 0:
        return scores_sorted.clone()
    from face_vijnana_yolov3_tpu_torch import kernels

    lib = kernels.load()
    out = torch.empty_like(scores_sorted)
    stream = torch.cuda.current_stream(boxes_sorted.device).cuda_stream
    with torch.cuda.device(boxes_sorted.device):
        rc = lib.fvy_nms_sweep(
            boxes_sorted.data_ptr(), scores_sorted.data_ptr(), out.data_ptr(),
            b, n, float(iou_th), stream,
        )
    if rc != 0:
        raise RuntimeError(f"nms_sweep: kernel launch failed, CUDA error {rc}")
    nms_sweep.launches += 1
    return out


nms_sweep.launches = 0  # kernel launches, counted where the kernel launches
