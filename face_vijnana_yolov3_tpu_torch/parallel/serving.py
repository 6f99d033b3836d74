"""Data-parallel serving over the mesh's "data" axis.

Port of face_vijnana_yolov3_tpu/parallel/serving.py (`detect_quant_dp`,
`identify_roi_dp`). The JAX functions are one SPMD program whose batch is
laid out P('data'); here every rank is handed the same global batch, runs
its contiguous B / data rows, and an all_gather over the data axis returns
the whole result on every rank, in batch order. Ranks that differ only in
their model index compute the same rows (the trunk is replicated over
"model", as in JAX). Every stage is per image or per ROI, so the forward
needs no other collective, and with the int8 trunk (integer arithmetic)
the result equals the single-process program's bit for bit.
"""

from __future__ import annotations

import torch

from face_vijnana_yolov3_tpu_torch.models import quant
from face_vijnana_yolov3_tpu_torch.parallel.mesh import (
    all_gather_cat,
    axis_group,
    batch_sharded,
    mesh_device,
    replicated,
)


def detect_quant_dp(model, mesh, qparams: dict, *, postprocess_cfg=None,
                    head_dtype=torch.bfloat16, fused_blocks: bool = False):
    """int8 fused detect, batch data-parallel over the mesh.

    The qparams are captured here, rank 0's on every rank, and a mixed tail's
    `tail_start` stays a Python int (serving.py:58-66). Returns
    fn(images (B, S, S, 3)) -> (cands, counts) with the detect_batch
    contract, or the raw (B, g, g, 6) head when postprocess_cfg is None; B
    must be divisible by the data axis. fused_blocks runs the eligible
    residual blocks through kernel A.
    """
    from face_vijnana_yolov3_tpu_torch.ops.postprocess import face_postprocess_batch

    dev = mesh_device()
    tail_start = qparams.get("tail_start")
    qp = replicated(quant.to_device({k: v for k, v in qparams.items()
                                     if k != "tail_start"}, dev), mesh)
    if tail_start is not None:
        qp["tail_start"] = int(tail_start)
    group = axis_group(mesh, "data")

    @torch.inference_mode()
    def fwd(images):
        x = batch_sharded(torch.as_tensor(images, dtype=torch.float32, device=dev), mesh)
        head = model.apply_quant(qp, x, head_dtype=head_dtype, fused_blocks=fused_blocks)
        if postprocess_cfg is None:
            return all_gather_cat(head, group)
        cands, counts = face_postprocess_batch(head, postprocess_cfg)
        return all_gather_cat(cands, group), all_gather_cat(counts, group)

    return fwd


def identify_roi_dp(embed_fn, mesh, *, image_size: int, window_h: int, window_w: int):
    """ROI identify (windowed crop + letterbox matmuls → embed → registry
    match) with the packed ROIs' bucket axis data-parallel over the mesh.

    embed_fn: crops (R, S, S, 3) f32 → (R, D) embeddings on this rank's
    device (e.g. a FaceIdentifierPipeline's `_embed_program`). Returns
    fn(staged (B, maxH, maxW, C), packed (n_sub, bucket, F), reg (R, D)) →
    (n_sub, bucket, 2) f32 rows [best_idx, best_dist]; `bucket` must be
    divisible by the data axis. The staged batch and the registry are read
    whole on every rank.
    """
    from face_vijnana_yolov3_tpu_torch.ops.roi import (
        roi_letterbox_device_windowed,
        unpack_roi_operands,
    )
    from face_vijnana_yolov3_tpu_torch.ops.similarity import match_embeddings

    dev = mesh_device()
    group = axis_group(mesh, "data")

    @torch.inference_mode()
    def fwd(staged, packed, reg):
        staged = torch.as_tensor(staged, device=dev)
        reg = torch.as_tensor(reg, dtype=torch.float32, device=dev)
        packed = torch.as_tensor(packed, dtype=torch.float32, device=dev)
        local = batch_sharded(packed.transpose(0, 1), mesh).transpose(0, 1)
        rows = []
        for p in local:
            org, ri, rw, ci, cw = unpack_roi_operands(p, image_size)
            crops = roi_letterbox_device_windowed(staged, org, ri, rw, ci, cw,
                                                  window_h=window_h, window_w=window_w)
            idx, dist = match_embeddings(embed_fn(crops), reg)
            rows.append(torch.stack([idx.to(torch.float32), dist], -1))
        return all_gather_cat(torch.stack(rows), group, dim=1)

    return fwd
