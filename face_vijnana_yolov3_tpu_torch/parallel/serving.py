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

Programs: as the JAX functions are jitted (serving.py:66, :126), each
returned function uploads its inputs eagerly and then replays one
captured program (core/programs.py) per key: the call's shapes and
`mesh.mesh_key` (the mesh's shape, this rank's coordinates). The program
holds this rank's rows of the work and the closing all_gather over
"data", which NCCL captures into the graph; its communicator exists
before the first capture (the broadcast of the qparams, or the warm-up
call that precedes each capture). Every rank must call with the same
shapes in the same order. On the CPU (gloo) a program is its eager
function.
"""

from __future__ import annotations

import torch

from face_vijnana_yolov3_tpu_torch.core.programs import ProgramCache
from face_vijnana_yolov3_tpu_torch.models import quant
from face_vijnana_yolov3_tpu_torch.parallel.mesh import (
    all_gather_cat,
    axis_group,
    batch_sharded,
    mesh_device,
    mesh_key,
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
    residual blocks through kernel A. fn.programs is its ProgramCache (key:
    "dp-detect", this rank's input shape, `mesh.mesh_key`), fn.program the
    eager function the program captures (this rank's rows → the gathered
    result).
    """
    from face_vijnana_yolov3_tpu_torch.ops.postprocess import face_postprocess_batch

    dev = mesh_device()
    tail_start = qparams.get("tail_start")
    qp = replicated(quant.to_device({k: v for k, v in qparams.items()
                                     if k != "tail_start"}, dev), mesh)
    if tail_start is not None:
        qp["tail_start"] = int(tail_start)
    group = axis_group(mesh, "data")
    programs = ProgramCache(dev)

    def program(x):
        head = model.apply_quant(qp, x, head_dtype=head_dtype, fused_blocks=fused_blocks)
        if postprocess_cfg is None:
            return all_gather_cat(head, group)
        cands, counts = face_postprocess_batch(head, postprocess_cfg)
        return all_gather_cat(cands, group), all_gather_cat(counts, group)

    @torch.inference_mode()
    def fwd(images):
        x = batch_sharded(torch.as_tensor(images, dtype=torch.float32, device=dev), mesh)
        return programs.run(("dp-detect", tuple(x.shape), *mesh_key(mesh)), program, x)

    fwd.programs, fwd.program = programs, program
    return fwd


def identify_roi_dp(embed_fn, mesh, *, image_size: int, window_h: int, window_w: int):
    """ROI identify (windowed crop + letterbox matmuls → embed → registry
    match) with the packed ROIs' bucket axis data-parallel over the mesh.

    embed_fn: crops (R, S, S, 3) f32 → (R, D) embeddings on this rank's
    device (e.g. a FaceIdentifierPipeline's `_embed_program`). Returns
    fn(staged (B, maxH, maxW, C), packed (n_sub, bucket, F), reg (R, D)) →
    (n_sub, bucket, 2) f32 rows [best_idx, best_dist]; `bucket` must be
    divisible by the data axis. The staged batch and the registry are read
    whole on every rank. embed_fn must be eager (no program of its own):
    the DP program captures it. fn.programs is its ProgramCache (key:
    "dp-roi", the shapes, the staged dtype, `mesh.mesh_key`), fn.program
    the eager function it captures, of (staged, this rank's bucket rows of
    packed, reg).
    """
    from face_vijnana_yolov3_tpu_torch.ops.roi import (
        roi_letterbox_device_windowed,
        unpack_roi_operands,
    )
    from face_vijnana_yolov3_tpu_torch.ops.similarity import match_embeddings

    dev = mesh_device()
    group = axis_group(mesh, "data")
    programs = ProgramCache(dev)

    def program(staged, local, reg):
        rows = []
        for p in local:
            org, ri, rw, ci, cw = unpack_roi_operands(p, image_size)
            crops = roi_letterbox_device_windowed(staged, org, ri, rw, ci, cw,
                                                  window_h=window_h, window_w=window_w)
            idx, dist = match_embeddings(embed_fn(crops), reg)
            rows.append(torch.stack([idx.to(torch.float32), dist], -1))
        return all_gather_cat(torch.stack(rows), group, dim=1)

    @torch.inference_mode()
    def fwd(staged, packed, reg):
        staged = torch.as_tensor(staged, device=dev)
        reg = torch.as_tensor(reg, dtype=torch.float32, device=dev)
        packed = torch.as_tensor(packed, dtype=torch.float32, device=dev)
        local = batch_sharded(packed.transpose(0, 1), mesh).transpose(0, 1)
        key = ("dp-roi", tuple(staged.shape), str(staged.dtype), tuple(local.shape),
               tuple(reg.shape), *mesh_key(mesh))
        return programs.run(key, program, staged, local, reg)

    fwd.programs, fwd.program = programs, program
    return fwd
