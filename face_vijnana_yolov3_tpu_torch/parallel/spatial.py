"""Spatial partitioning of the conv grid: image height split over the
mesh's "model" axis, the batch over "data".

Port of face_vijnana_yolov3_tpu/parallel/spatial.py (`detect_spatial`).
The JAX version lays images out P('data', 'model') and lets GSPMD insert
the halo exchanges; here they are written out. At every activation level
of height H each model rank owns the even band [⌊H·i/M⌋, ⌊H·(i+1)/M⌋),
which may be empty when the level has fewer rows than ranks (a 64-row
image over 4 ranks leaves a 2-row head grid). Before a 3x3 conv, the
output band [lo, hi) needs input rows [s·lo − 1, s·(hi − 1) + 2) (stride
s, clipped to the image): a rank sends to every other rank the rows of its
own band that rank needs and receives its own missing rows, with one
`batch_isend_irecv` (one row from each neighbour at stride 1, one from the
upper neighbour at stride 2 when the bands line up, more when they do not).
The rows outside the image are the conv's zero padding. 1x1 convs, the
bias, leaky and the residual adds are per row. The conv and dtype rules
are darknet.apply_graph_folded's, so the result equals the unsharded
program within f32 rounding; the head is gathered over "model" and then
"data", and postprocess runs per image on the whole head.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from face_vijnana_yolov3_tpu_torch.models import darknet
from face_vijnana_yolov3_tpu_torch.parallel.mesh import (
    all_gather_cat,
    axis_group,
    axis_rank,
    axis_size,
    batch_sharded,
    mesh_device,
)


def band(h: int, m: int, i: int) -> tuple[int, int]:
    """Rows [lo, hi) of an h-row level that band i of m owns."""
    return h * i // m, h * (i + 1) // m


def _needed(lo: int, hi: int, stride: int, h_in: int) -> tuple[int, int]:
    """Input rows a 3x3 conv's output rows [lo, hi) read, clipped to the image."""
    if lo >= hi:
        return 0, 0
    return max(0, stride * lo - 1), min(h_in, stride * (hi - 1) + 2)


class _Bands:
    """This rank's place on the model axis and the halo exchange."""

    def __init__(self, mesh):
        self.m = axis_size(mesh, "model")
        self.i = axis_rank(mesh, "model")
        group = axis_group(mesh, "model")
        self.peers = (dist.get_process_group_ranks(group) if group is not None
                      else [0])

    def own(self, h: int) -> tuple[int, int]:
        return band(h, self.m, self.i)

    def gather_rows(self, x: torch.Tensor, h_in: int, needs: list[tuple[int, int]]):
        """The rows `needs[i]` this rank i needs of the level (height h_in)
        whose band it holds as x (B, rows, W, C): its own rows plus the
        other ranks'. `needs` holds every model rank's need, so that this
        rank also sends what the others need from it."""
        need = needs[self.i]
        own_lo, own_hi = self.own(h_in)
        ops, pieces = [], []
        for q in range(self.m):
            q_lo, q_hi = band(h_in, self.m, q)
            if q == self.i:
                lo, hi = max(need[0], own_lo), min(need[1], own_hi)
                if lo < hi:
                    pieces.append((lo, x[:, lo - own_lo:hi - own_lo]))
                continue
            lo, hi = needs[q]  # what q needs, of this rank's rows
            lo, hi = max(lo, own_lo), min(hi, own_hi)
            if lo < hi:
                ops.append(dist.P2POp(dist.isend, x[:, lo - own_lo:hi - own_lo].contiguous(),
                                      self.peers[q]))
            lo, hi = max(need[0], q_lo), min(need[1], q_hi)
            if lo < hi:
                buf = x.new_empty((x.shape[0], hi - lo, *x.shape[2:]))
                ops.append(dist.P2POp(dist.irecv, buf, self.peers[q]))
                pieces.append((lo, buf))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        pieces.sort(key=lambda p: p[0])
        if not pieces:
            return x[:, :0]
        return torch.cat([p for _, p in pieces], dim=1)

    def conv3x3(self, x, kernel, stride: int, h_in: int):
        """This rank's output band of a 3x3 'same' conv (pad 1) over the
        level of height h_in → (output band, output height)."""
        h_out = (h_in - 1) // stride + 1
        out_lo, out_hi = self.own(h_out)
        needs = [_needed(*band(h_out, self.m, q), stride, h_in) for q in range(self.m)]
        need = needs[self.i]
        rows = self.gather_rows(x, h_in, needs)
        if out_lo >= out_hi:
            w_out = (x.shape[2] - 1) // stride + 1
            return x.new_empty((x.shape[0], 0, w_out, kernel.shape[0])), h_out
        pad_top = need[0] - (stride * out_lo - 1)
        pad_bottom = stride * (out_hi - 1) + 2 - need[1]
        y = F.conv2d(F.pad(rows.permute(0, 3, 1, 2), (1, 1, pad_top, pad_bottom)),
                     kernel, stride=stride)
        return y.permute(0, 2, 3, 1), h_out


def _apply_folded_bands(bands: _Bands, folded: dict, x: torch.Tensor, ops: list,
                        height: int, *, compute_dtype, f32_front_ops: int):
    """darknet.apply_graph_folded over this rank's row band of x (the
    trunk graph: conv, save, add, output) → (the trunk band, its height)."""
    saved = {}
    h, level = x, height
    with darknet.exact_f32():
        for i, op in enumerate(ops):
            kind = op[0]
            op_dtype = torch.float32 if i < f32_front_ops else compute_dtype
            if kind == "conv":
                _, idx, _out_c, k, stride, _bn, act = op
                p = folded[f"conv_{idx}"]
                kern = p["kernel"].to(op_dtype)
                if k == 1 and h.shape[1] == 0:  # an empty band stays empty
                    h = h.new_empty((*h.shape[:3], kern.shape[0]), dtype=op_dtype)
                elif k == 1:
                    h = darknet.conv_nhwc(h.to(op_dtype), kern, stride)
                else:
                    h, level = bands.conv3x3(h.to(op_dtype), kern, stride, level)
                h = h + p["bias"]
                if act:
                    h = darknet.leaky(h)
                h = h.to(op_dtype)
            elif kind in ("save", "mark"):
                saved[op[1]] = h
            elif kind == "add":
                h = saved[op[1]] + h
            elif kind == "output":
                return h.float(), level
            else:
                raise ValueError(f"detect_spatial: op {op} is not in the trunk graph")
    raise ValueError("detect_spatial: the graph has no output")


def detect_spatial(model, mesh, *, compute_dtype=torch.bfloat16, postprocess_cfg=None,
                   f32_front_blocks: int = 0):
    """Folded detect with the batch over "data" and the image height over
    "model" (spatial.py:41-74).

    Returns fn(folded, images (B, H, W, 3)) -> (cands, counts) on every
    rank, the single-card serving contract, or the raw (B, H/32, W/32, 6)
    head when postprocess_cfg is None. Every rank passes the same global
    batch and folded params; B must be divisible by the data axis.
    f32_front_blocks: the bf16 input-noise guard (FdConf.bf16_f32_front).
    """
    from face_vijnana_yolov3_tpu_torch.ops.postprocess import face_postprocess_batch

    dev = mesh_device()
    bands = _Bands(mesh)
    front = (darknet.front_end_index(model.ops, f32_front_blocks)
             if f32_front_blocks else 0)

    @torch.inference_mode()
    def fwd(folded, images):
        x = batch_sharded(torch.as_tensor(images, device=dev), mesh)
        height = x.shape[1]
        lo, hi = bands.own(height)
        trunk, level = _apply_folded_bands(bands, folded, x[:, lo:hi], model.ops, height,
                                           compute_dtype=compute_dtype,
                                           f32_front_ops=front)
        hp = folded["head"]
        with darknet.exact_f32():
            head, _ = bands.conv3x3(trunk.to(compute_dtype),
                                    hp["kernel"].to(compute_dtype), 1, level)
        head = (head + hp["bias"]).float()
        head = _gather_bands(head, bands, level, axis_group(mesh, "model"))
        head = all_gather_cat(head, axis_group(mesh, "data"))
        if postprocess_cfg is None:
            return head
        return face_postprocess_batch(head, postprocess_cfg)

    return fwd


def _gather_bands(x: torch.Tensor, bands: _Bands, h: int, group) -> torch.Tensor:
    """The whole (B, h, W, C) level from every model rank's band (bands of
    unequal height are padded to the largest for the all_gather)."""
    if group is None:
        return x
    rows = max(band(h, bands.m, q)[1] - band(h, bands.m, q)[0] for q in range(bands.m))
    padded = F.pad(x, (0, 0, 0, 0, 0, rows - x.shape[1]))
    parts = all_gather_cat(padded[None], group)
    return torch.cat([parts[q, :, :band(h, bands.m, q)[1] - band(h, bands.m, q)[0]]
                      for q in range(bands.m)], dim=1)
