"""One fused int8 Darknet residual block: the CUDA kernel's wrapper and its
plain twin.

`block_int8` is the port of face_vijnana_yolov3_tpu/ops/pallas_block.py::
fused_block_int8 (the Pallas `_block_kernel`): 1x1 conv + epilogue, requant
to the mid scales, 3x3 conv over that int8 intermediate (zero padded) +
epilogue, skip dequant-add, one requant to the block's output scales —
bit-exact with models/quant.py::apply_graph_quant's stock path, whose
epilogues ops/conv_int8.py describes. A CUDA tensor goes to the
hand-written kernel in csrc/block_int8.cu, which keeps the 1x1 result in
shared memory; a CPU tensor to `block_int8_reference`, two plain int8
convs. There is no fallback between the two. The Pallas `shift_mode`
switch worked around Mosaic and has no counterpart here.
"""

from __future__ import annotations

import torch

from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import (
    _check_cuda,
    conv_int8_reference,
)

# csrc/block_int8.cu: the GEMM tiles are 128 channels wide.
CHANNEL_MULTIPLE = 128
# Shared memory for the 1x1 intermediate of one block, chosen so two blocks
# fit on an H100 SM (227 KB) beside their 18 KB of operand tiles.
Y_BYTES_CAP = 95 * 1024
# Blocks a launch should reach before it stops splitting output channels
# (two waves on the 132 SMs of an H100).
TARGET_BLOCKS = 264


def block_eligible(in_c: int, mid_c: int) -> bool:
    """Both channel counts multiples of 128 (pallas_block.py:78-85): the
    blocks of trunk stages 3/4/5 (256/128, 512/256, 1024/512), not those of
    stages 1/2."""
    return in_c % CHANNEL_MULTIPLE == 0 and mid_c % CHANNEL_MULTIPLE == 0


def launch_config(batch: int, h: int, w: int, c: int, ch: int) -> tuple[int, int]:
    """(rows, n_split) for csrc/block_int8.cu: output rows per block, the
    most whose intermediate (rows + 2) x (w + 2) x (ch + 16) bytes fits
    Y_BYTES_CAP, spread evenly over the image's row tiles; then the output
    channels split in 2 or 4 while the launch has fewer than TARGET_BLOCKS
    blocks."""
    row_bytes = (w + 2) * (ch + 16)
    max_rows = max(1, min(h, Y_BYTES_CAP // row_bytes - 2))
    tiles = -(-h // max_rows)
    rows = -(-h // tiles)
    n_split = 1
    while (tiles * batch * n_split < TARGET_BLOCKS and n_split < 4
           and (c // (2 * n_split)) % CHANNEL_MULTIPLE == 0):
        n_split *= 2
    return rows, n_split


def block_int8_reference(x_q, w1_q, w2_q, ws1, b1, inv_s_mid, ws2, b2, skip_s,
                         inv_s_out) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments as `block_int8`)."""
    y1 = conv_int8_reference(x_q, w1_q, ws1, b1, inv_s_mid, stride=1, leaky=True)
    return conv_int8_reference(y1, w2_q, ws2, b2, inv_s_out, stride=1,
                               leaky=True, skip_q=x_q, skip_s=skip_s)


def block_int8(x_q: torch.Tensor, w1_q: torch.Tensor, w2_q: torch.Tensor,
               ws1: torch.Tensor, b1: torch.Tensor, inv_s_mid: torch.Tensor,
               ws2: torch.Tensor, b2: torch.Tensor, skip_s: torch.Tensor,
               inv_s_out: torch.Tensor) -> torch.Tensor:
    """One int8 residual block, fused. x_q (B, H, W, C) int8.

    w1_q (Ch, 1, 1, C) and w2_q (C, 3, 3, Ch) int8, OHWI (input scales
    pre-folded, as quantize_folded leaves them); ws1, b1, inv_s_mid (Ch,)
    and ws2, b2, skip_s, inv_s_out (C,) f32. → (B, H, W, C) int8 at the
    post-add activation scales.
    """
    args = (x_q, w1_q, w2_q, ws1, b1, inv_s_mid, ws2, b2, skip_s, inv_s_out)
    if all(a.device.type == "cpu" for a in args):
        return block_int8_reference(*args)
    b, h, w, c = x_q.shape
    ch = w1_q.shape[0]
    if (w1_q.shape != (ch, 1, 1, c) or w2_q.shape != (c, 3, 3, ch)
            or not block_eligible(c, ch)):
        raise ValueError(f"block_int8: x {tuple(x_q.shape)}, w1 "
                         f"{tuple(w1_q.shape)}, w2 {tuple(w2_q.shape)}: need "
                         "(Ch,1,1,C) and (C,3,3,Ch) with C, Ch multiples of 128")
    names = ("x_q", "w1_q", "w2_q", "ws1", "b1", "inv_s_mid", "ws2", "b2",
             "skip_s", "inv_s_out")
    tensors = dict(zip(names, args))
    dtypes = {n: (torch.int8 if n.endswith("_q") else torch.float32) for n in names}
    for n in ("ws1", "b1", "inv_s_mid"):
        if tensors[n].shape != (ch,):
            raise ValueError(f"block_int8: {n} must have shape ({ch},)")
    for n in ("ws2", "b2", "skip_s", "inv_s_out"):
        if tensors[n].shape != (c,):
            raise ValueError(f"block_int8: {n} must have shape ({c},)")
    dev = _check_cuda("block_int8", tensors, dtypes)
    out = torch.empty_like(x_q)
    if out.numel() == 0:
        return out
    from face_vijnana_yolov3_tpu_torch import kernels

    lib = kernels.load()
    rows, n_split = launch_config(b, h, w, c, ch)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.fvy_block_int8(*(t.data_ptr() for t in args), out.data_ptr(),
                                b, h, w, c, ch, rows, n_split, stream)
    if rc != 0:
        raise RuntimeError(f"block_int8: kernel launch failed, CUDA error {rc}")
    block_int8.launches += 1
    return out


block_int8.launches = 0  # kernel launches, counted where the kernel launches
