"""The port's four kernels as `torch.library` custom ops, `fvy::*`.

`torch.export` cannot trace through a ctypes launch (a fake tensor has no
`data_ptr()`), so each kernel is also an op with a schema, a CPU kernel, a
CUDA kernel and a fake (shape-only) implementation:

    fvy::conv_int8    A0, csrc/conv_int8.cu    (B, Ho, Wo, Cout) int8
    fvy::block_int8   A,  csrc/block_int8.cu   empty_like(x_q)
    fvy::nms_sweep    B,  csrc/nms_sweep.cu    empty_like(scores)
    fvy::fused_front  C,  csrc/front_fused.cu  (B, S/2, S/2, 64) bf16

The CPU kernel is the module's plain version and the CUDA kernel its
`*_cuda` launch (checks, `torch.empty` outputs, the ctypes launch on the
current stream, a raise on a nonzero return code), the very functions an
eager call reaches (kernels.direct_route), so each kernel has one
implementation and its `.launches` counter counts both routes.
`fvy::fused_front` takes the re-laid weights of
`front_fused.front_kernel_weights`, not the folded dict.

Importing this module registers the ops and builds nothing
(kernels.load builds on the first CUDA launch). An exported program that
holds `fvy::` nodes needs it imported before `torch.export.load`
(core/export.load_artifact does that).
"""

from __future__ import annotations

from typing import Optional

import torch

from face_vijnana_yolov3_tpu_torch.ops import block_int8 as _block
from face_vijnana_yolov3_tpu_torch.ops import conv_int8 as _conv
from face_vijnana_yolov3_tpu_torch.ops import front_fused as _front
from face_vijnana_yolov3_tpu_torch.ops import nms_sweep as _nms


@torch.library.custom_op("fvy::conv_int8", mutates_args=(), device_types="cpu")
def conv_int8(x_q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              bias: torch.Tensor, inv_out: torch.Tensor, skip_q: Optional[torch.Tensor],
              skip_s: Optional[torch.Tensor], stride: int, leaky: bool) -> torch.Tensor:
    return _conv.conv_int8_reference(x_q, w_q, w_scale, bias, inv_out, stride=stride,
                                     leaky=leaky, skip_q=skip_q, skip_s=skip_s)


conv_int8.register_kernel("cuda")(_conv.conv_int8_cuda)


@conv_int8.register_fake
def _(x_q, w_q, w_scale, bias, inv_out, skip_q, skip_s, stride, leaky):
    b, h, w, _ = x_q.shape
    ho, wo = _conv.out_size(h, w, w_q.shape[1], stride)
    return x_q.new_empty((b, ho, wo, w_q.shape[0]))


@torch.library.custom_op("fvy::block_int8", mutates_args=(), device_types="cpu")
def block_int8(x_q: torch.Tensor, w1_q: torch.Tensor, w2_q: torch.Tensor,
               ws1: torch.Tensor, b1: torch.Tensor, inv_s_mid: torch.Tensor,
               ws2: torch.Tensor, b2: torch.Tensor, skip_s: torch.Tensor,
               inv_s_out: torch.Tensor) -> torch.Tensor:
    return _block.block_int8_reference(x_q, w1_q, w2_q, ws1, b1, inv_s_mid, ws2, b2,
                                       skip_s, inv_s_out)


block_int8.register_kernel("cuda")(_block.block_int8_cuda)


@block_int8.register_fake
def _(x_q, *_):
    return torch.empty_like(x_q)


@torch.library.custom_op("fvy::nms_sweep", mutates_args=(), device_types="cpu")
def nms_sweep(boxes_sorted: torch.Tensor, scores_sorted: torch.Tensor,
              iou_th: float) -> torch.Tensor:
    return _nms.nms_sweep_reference(boxes_sorted, scores_sorted, iou_th)


nms_sweep.register_kernel("cuda")(_nms.nms_sweep_cuda)


@nms_sweep.register_fake
def _(boxes_sorted, scores_sorted, iou_th):
    return torch.empty_like(scores_sorted)


@torch.library.custom_op("fvy::fused_front", mutates_args=(), device_types="cpu")
def fused_front(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                b1: torch.Tensor) -> torch.Tensor:
    return _front.fused_front_plain(x, _front.weights_to_folded(w0, b0, w1, b1))


fused_front.register_kernel("cuda")(_front.fused_front_cuda)


@fused_front.register_fake
def _(x, w0, b0, w1, b1):
    b, s = x.shape[0], x.shape[1]
    return x.new_empty((b, s // 2, s // 2, _front.C1), dtype=torch.bfloat16)
