"""The fused trunk front, conv_0 → leaky → conv_1 → leaky: the CUDA kernel's
wrapper and its plain twin.

Port of face_vijnana_yolov3_tpu/ops/pallas_front.py:49-171 (the Pallas
`_front_kernel`, `fused_front` and `apply_graph_folded_front`). What it
computes, in `compute_dtype` (bf16 on the card) with f32 accumulation:

    y = leaky(conv3x3_s1(round(x), round(k0)) + b0)        f32, (B, S, S, 32)
    y[row -1], y[col -1] = 0                                conv_1's zero padding
    z = leaky(conv3x3_s2(round(y), round(k1)) + b1)        f32
    out = round(z)                                          (B, S/2, S/2, 64)

where round() is the cast to `compute_dtype`. The biases are added to the
f32 sums before any rounding, so the result is rounded once per conv. The
stock bf16 path (darknet.apply_graph_folded) rounds each conv's sum to bf16
before its bias add instead, so the two differ by a bf16 step on a few
elements; the port's kernel and its twin follow `fused_front`.

A CUDA tensor goes to the hand-written kernel in csrc/front_fused.cu (a
persistent, TMA-fed kernel: conv_0 on mma.sync, conv_1 on wgmma), which
keeps conv_0's S²×32 output in shared memory; a CPU tensor to
`fused_front_plain`. There is no fallback between the two.

Divergence of signature: the JAX `fused_front` takes the space-to-depth
tree of models/s2d.build_s2d_folded; the port does not carry s2d (its
motivation was TPU tiling) and reads the ordinary folded `conv_0`/`conv_1`
kernels (OIHW). A JAX `folded_s2d` tree converted by
`convert.folded_from_jax` works unchanged: its extra `s2d_conv*` keys are
ignored.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from face_vijnana_yolov3_tpu_torch.models import darknet

C0, C1 = 32, 64  # conv_0 and conv_1 output channels (darknet.trunk_graph)


def _front_params(folded: dict):
    p0, p1 = folded["conv_0"], folded["conv_1"]
    k0, k1 = p0["kernel"], p1["kernel"]
    if tuple(k0.shape) != (C0, 3, 3, 3) or tuple(k1.shape) != (C1, C0, 3, 3):
        raise ValueError(f"fused_front: conv_0 {tuple(k0.shape)} and conv_1 "
                         f"{tuple(k1.shape)} kernels; expected (32, 3, 3, 3) "
                         "and (64, 32, 3, 3) OIHW")
    return k0, p0["bias"], k1, p1["bias"]


def _check_input(x: torch.Tensor):
    b, h, w, c = x.shape
    assert h == w and h % 2 == 0 and c == 3, x.shape
    return b, h


def fused_front_plain(x: torch.Tensor, folded: dict, *,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments as `fused_front`;
    f32 or bf16 `compute_dtype`). bf16 operands are exact in f32 and so are
    their products, so an f32 convolution of the rounded values is the f32
    accumulation the kernel does, up to summation order."""
    _check_input(x)
    k0, b0, k1, b1 = _front_params(folded)

    def rounded(t):
        return t.to(compute_dtype).float()

    with darknet.exact_f32():
        y = F.conv2d(rounded(x).permute(0, 3, 1, 2), rounded(k0), padding=1)
        y = rounded(darknet.leaky(y + b0[:, None, None]))
        z = F.conv2d(y, rounded(k1), stride=2, padding=1)
        z = darknet.leaky(z + b1[:, None, None]).to(compute_dtype)
    return z.permute(0, 2, 3, 1).contiguous()


def front_kernel_weights(folded: dict):
    """(w0 (32, 48) bf16, b0 (32,) f32, w1 (64, 288) bf16, b1 (64,) f32) in
    the layout of csrc/front_fused.cu: output channel rows, K contiguous.
    conv_0's K is 16 dy + 4 dx + cin: each kernel row dy is 4 pixels x 4
    channels, the kernel's 3 pixels x 3 channels with zeros at dx = 3 and
    cin = 3 (the 4-channel patch pixels its A rows read). conv_1's K is
    (dy, dx, cin) = 32 (3 dy + dx) + cin."""
    k0, b0, k1, b1 = _front_params(folded)
    w0 = F.pad(k0.permute(0, 2, 3, 1), (0, 1, 0, 1)).reshape(C0, 48)  # (o, dy, dx4, c4)
    w1 = k1.permute(0, 2, 3, 1).reshape(C1, 9 * C0)
    return (w0.to(torch.bfloat16).contiguous(), b0.float().contiguous(),
            w1.to(torch.bfloat16).contiguous(), b1.float().contiguous())


def fused_front(x: torch.Tensor, folded: dict, *,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(B, S, S, 3) NHWC f32 → conv_1's output (B, S/2, S/2, 64), post-leaky,
    in `compute_dtype`. `folded` holds the folded "conv_0" and "conv_1"
    ({"kernel" OIHW f32, "bias" f32}) on x's device. Square input, even S.
    The CUDA kernel computes in bf16 only."""
    b, s = _check_input(x)
    if x.device.type == "cpu":
        return fused_front_plain(x, folded, compute_dtype=compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"fused_front: the CUDA kernel computes in bf16, not "
                         f"{compute_dtype}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"fused_front: x must be contiguous float32, got {x.dtype}")
    weights = front_kernel_weights(folded)
    if any(t.device != x.device for t in weights):
        raise ValueError(f"fused_front: x on {x.device}, the folded conv_0/conv_1 "
                         "params elsewhere; all must be on one device")
    if x.device.type != "cuda":
        raise ValueError(f"fused_front: tensors on {x.device}; expected one "
                         "CUDA device or the CPU")
    if any(t.data_ptr() % 16 for t in (x, *weights)):
        raise ValueError("fused_front: operands must be 16-byte aligned")
    out = torch.empty((b, s // 2, s // 2, C1), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    from face_vijnana_yolov3_tpu_torch import kernels

    lib = kernels.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.fvy_front_fused(x.data_ptr(), *(t.data_ptr() for t in weights),
                                 out.data_ptr(), b, s, stream)
    if rc == -1:
        raise RuntimeError("fused_front: x's TMA tensor map could not be encoded")
    if rc != 0:
        raise RuntimeError(f"fused_front: kernel launch failed, CUDA error {rc}")
    fused_front.launches += 1
    return out


fused_front.launches = 0  # kernel launches, counted where the kernel launches


def apply_graph_folded_front(folded: dict, x: torch.Tensor, ops: list[tuple], *,
                             compute_dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """Folded inference with the fused front (pallas_front.py:153-171):
    `fused_front` for conv_0/conv_1, then darknet.apply_graph_folded from
    the third op. The graph must open with conv_0, conv_1. Outputs are f32."""
    assert ops[0][:2] == ("conv", 0) and ops[1][:2] == ("conv", 1), ops[:2]
    h = fused_front(x, folded, compute_dtype=compute_dtype)
    return darknet.apply_graph_folded(folded, h, ops[2:],
                                      compute_dtype=compute_dtype)
