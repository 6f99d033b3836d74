"""One fused int8 Darknet residual block: the CUDA kernel's wrapper and its
plain twin.

`block_int8` is the port of face_vijnana_yolov3_tpu/ops/pallas_block.py::
fused_block_int8 (the Pallas `_block_kernel`): 1x1 conv + epilogue, requant
to the mid scales, 3x3 conv over that int8 intermediate (zero padded) +
epilogue, skip dequant-add, one requant to the block's output scales —
bit-exact with models/quant.py::apply_graph_quant's stock path, whose
epilogues ops/conv_int8.py describes. A CUDA tensor goes to the
hand-written kernel in csrc/block_int8.cu (TMA-fed wgmma; the 1x1 result
stays in shared memory in the layout the 3x3's products read), with the
band and channel split that `launch_config` picks; a CPU tensor to `block_int8_reference`, two plain int8
convs. There is no fallback between the two. The pair is also the custom
op `fvy::block_int8` (ops/library.py). The Pallas `shift_mode`
switch worked around Mosaic and has no counterpart here.
"""

from __future__ import annotations

import functools

import torch

from face_vijnana_yolov3_tpu_torch import kernels
from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import (
    _check_cuda,
    conv_int8_reference,
    raise_on_error,
)

# csrc/block_int8.cu: tiles of 128 pixels x 128 channels x 128 K bytes, a
# ring of 3 stages of two 16 KB boxes, the epilogue's 128 x 144-byte staging
# and 2 KB of channel parameters, and the shared memory of one H100 block
# and one SM.
CHANNEL_MULTIPLE = 128
TILE = 128
RING_BYTES = 3 * 2 * TILE * TILE
STAGING_BYTES = TILE * (TILE + 16) + 16 * TILE
BLOCK_SMEM_LIMIT = 232448
SM_SMEM = 233472
SM_COUNT = 132


def block_eligible(in_c: int, mid_c: int) -> bool:
    """Both channel counts multiples of 128 (pallas_block.py:78-85): the
    blocks of trunk stages 3/4/5 (256/128, 512/256, 1024/512), not those of
    stages 1/2."""
    return in_c % CHANNEL_MULTIPLE == 0 and mid_c % CHANNEL_MULTIPLE == 0


def y_pixels(rows: int, w: int) -> int:
    """Pixels P of the kernel's intermediate Y: the (rows + 2) x (w + 2)
    band plus the slack that phase 2's last 128-row tile reads at the
    bottom-right tap (csrc/block_int8.cu y_pixels)."""
    m2 = -(-rows * (w + 2) // TILE) * TILE
    return (m2 + 2 * (w + 2) + 2 + 7) // 8 * 8


def block_smem(w: int, ch: int, rows: int) -> int:
    """Dynamic shared memory of one block (csrc/block_int8.cu block_smem)."""
    return 1024 + RING_BYTES + ch * y_pixels(rows, w) + STAGING_BYTES + 48


def block_tiles(h: int, w: int, c: int, ch: int, rows: int, n_split: int) -> int:
    """128x128x128 product tiles one block runs for a band of `rows` rows:
    the 1x1 over (rows + 2) x w pixels (halo recomputed, all Ch channels
    whatever n_split), then the 3x3 over rows x (w + 2) padded-width rows
    for C / n_split channels."""
    t = TILE
    m1 = (min(rows, h) + 2) * w
    m2 = rows * (w + 2)
    return (-(-m1 // t) * (ch // t) * (c // t)
            + -(-m2 // t) * (c // n_split // t) * (9 * ch // t))


@functools.cache
def launch_config(batch: int, h: int, w: int, c: int, ch: int) -> tuple[int, int]:
    """(rows, n_split) for csrc/block_int8.cu: output rows per block and
    the number of blocks that share a band's output channels.

    Every (rows, n_split) whose block fits the shared memory is scored by
    waves x blocks per SM x tiles per block (the tensor cores are the
    bound, blocks on one SM share them), with rows evened out over the
    image's bands; the least wins, then the fewest blocks.
    """
    best = None
    for bands in range(1, h + 1):
        rows = -(-h // bands)
        if -(-h // rows) != bands:
            continue
        smem = block_smem(w, ch, rows)
        if smem > BLOCK_SMEM_LIMIT:
            continue
        per_sm = max(1, SM_SMEM // (smem + 1024))
        for n_split in (1, 2, 4):
            if (c // n_split) % CHANNEL_MULTIPLE or c % n_split:
                continue
            blocks = batch * bands * n_split
            waves = -(-blocks // (SM_COUNT * per_sm))
            cost = waves * per_sm * block_tiles(h, w, c, ch, rows, n_split)
            key = (cost, blocks, n_split)
            if best is None or key < best[0]:
                best = (key, rows, n_split)
    if best is None:
        raise ValueError(f"block_int8: no band of a {w}-wide image with Ch {ch} "
                         f"fits {BLOCK_SMEM_LIMIT} bytes of shared memory")
    return best[1], best[2]


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
    post-add activation scales. Eager calls run `block_int8_impl`; under
    `torch.export` the call is the op `fvy::block_int8`.
    """
    args = (x_q, w1_q, w2_q, ws1, b1, inv_s_mid, ws2, b2, skip_s, inv_s_out)
    if kernels.direct_route():
        return block_int8_impl(*args)
    return kernels.fvy_ops().block_int8(*args)


def block_int8_impl(*args) -> torch.Tensor:
    """The plain version for CPU tensors, else the kernel (`block_int8_cuda`)."""
    if all(a.device.type == "cpu" for a in args):
        return block_int8_reference(*args)
    return block_int8_cuda(*args)


def block_int8_cuda(x_q, w1_q, w2_q, ws1, b1, inv_s_mid, ws2, b2, skip_s,
                    inv_s_out) -> torch.Tensor:
    """Check the operands, then launch csrc/block_int8.cu on the current
    stream; raises on anything the kernel does not take or a failed launch."""
    args = (x_q, w1_q, w2_q, ws1, b1, inv_s_mid, ws2, b2, skip_s, inv_s_out)
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
    lib = kernels.load()
    rows, n_split = launch_config(b, h, w, c, ch)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.fvy_block_int8(*(t.data_ptr() for t in args), out.data_ptr(),
                                b, h, w, c, ch, rows, n_split, stream)
    raise_on_error("block_int8", rc)
    block_int8.launches += 1
    return out


kernels.counts_launches("block_int8_kernel")(block_int8)
