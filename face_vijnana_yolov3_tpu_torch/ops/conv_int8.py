"""int8 convolution with its fused requantizing epilogue: the CUDA kernel's
wrapper and its plain twin.

`conv_int8` computes what face_vijnana_yolov3_tpu/models/quant.py::_conv_int8
(:666-675) and the epilogue of apply_graph_quant (:803-816) compute:

    acc = int32 conv(x_q, w_q)            k in {1, 3}, stride in {1, 2}, pad k//2
    h   = fma(acc, w_scale, bias)         f32, one rounding
    h   = where(h > 0, h, 0.1 * h)        when `leaky`
    h   = fma(skip_q, skip_s, h)          when a residual skip is fused
    out = clip(round_half_even(h * inv_out), -127, 127) as int8

NHWC activations, OHWI weights (Cout, k, k, Cin). The two multiply-adds are
single roundings because that is what the JAX package's jitted program
computes: XLA contracts `acc * w_scale + bias` and `h + skip * skip_s` into
FMAs (tests/test_torch_conv_int8.py holds the plain twin to the jitted
program bit for bit; an unfused multiply-add differs in about a quarter of
the values). The CUDA kernel writes them as __fmaf_rn; the plain twin
rounds once through float64 (`fma_f32`).

A CUDA tensor goes to the hand-written kernel in csrc/conv_int8.cu; a CPU
tensor to `conv_int8_reference`. There is no fallback between the two: a
CUDA call that cannot build or launch raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from face_vijnana_yolov3_tpu_torch.models.darknet import leaky as leaky_relu


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 `a * b + c` rounded once, as a fused multiply-add rounds it.

    a * b of two f32 values is exact in float64; the sum is rounded to
    float64 with round-to-odd (Knuth's TwoSum gives the error; an inexact
    sum with an even last bit steps to its odd neighbour toward the exact
    value), and float64 → float32 then rounds to nearest even. Round-to-odd
    at 53 bits followed by rounding to 24 bits gives the correctly rounded
    result (Boldo & Melquiond), so no double-rounding case is left.
    """
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(inexact_even, torch.nextafter(s, toward), s)
    return s.float()


def quantize(h: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """clip(round_half_even(h * inv), -127, 127) as int8 (quant.py:678-680)."""
    return torch.round(h * inv).clamp_(-127, 127).to(torch.int8)


def requant_reference(acc: torch.Tensor, w_scale, bias, inv_out, *,
                      leaky: bool, skip_q: torch.Tensor | None = None,
                      skip_s=None) -> torch.Tensor:
    """The fused epilogue on an exact accumulator (any integer-valued dtype)."""
    h = fma_f32(acc.float(), w_scale, bias)
    if leaky:
        h = leaky_relu(h)
    if skip_q is not None:
        h = fma_f32(skip_q.float(), skip_s, h)
    return quantize(h, inv_out)


def conv_acc_reference(x_q: torch.Tensor, w_q: torch.Tensor,
                       stride: int) -> torch.Tensor:
    """Exact int8 convolution sums as float64, NHWC.

    Every product is an integer of at most 127² and every sum has at most
    k²·Cin ≤ 9·1024 terms, so each partial sum is an integer below 2^28 and
    float64 holds it exactly, in any summation order. (CUDA has no int32
    convolution, so one float64 version serves the CPU and the card; cuDNN
    is bypassed because its FFT and Winograd algorithms are not exact.)
    """
    k = w_q.shape[1]
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x_q.permute(0, 3, 1, 2).double(),
                       w_q.permute(0, 3, 1, 2).double(),
                       stride=stride, padding=k // 2)
    return acc.permute(0, 2, 3, 1)


def conv_int8_reference(x_q, w_q, w_scale, bias, inv_out, *, stride: int,
                        leaky: bool, skip_q=None, skip_s=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments as `conv_int8`)."""
    return requant_reference(conv_acc_reference(x_q, w_q, stride), w_scale,
                             bias, inv_out, leaky=leaky, skip_q=skip_q,
                             skip_s=skip_s)


def _check_cuda(name: str, tensors: dict, dtypes: dict) -> torch.device:
    dev = next(iter(tensors.values())).device
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, expected {dev}; all "
                             "tensors must be on one CUDA device or the CPU")
        if t.dtype != dtypes[key]:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {dtypes[key]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.dtype == torch.int8 and t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; expected one CUDA device "
                         "or the CPU")
    return dev


def conv_int8(x_q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              bias: torch.Tensor, inv_out: torch.Tensor, *, stride: int,
              leaky: bool, skip_q: torch.Tensor | None = None,
              skip_s: torch.Tensor | None = None) -> torch.Tensor:
    """int8 conv + fused epilogue.

    x_q (B, H, W, Cin) int8; w_q (Cout, k, k, Cin) int8 with k in {1, 3};
    w_scale, bias, inv_out (Cout,) f32; skip_q (B, Ho, Wo, Cout) int8 with
    skip_s (Cout,) f32, or neither. → (B, Ho, Wo, Cout) int8.
    """
    if (skip_q is None) != (skip_s is None):
        raise ValueError("conv_int8: pass skip_q and skip_s together")
    if x_q.device.type == "cpu" and w_q.device.type == "cpu":
        return conv_int8_reference(x_q, w_q, w_scale, bias, inv_out,
                                   stride=stride, leaky=leaky, skip_q=skip_q,
                                   skip_s=skip_s)
    b, h, w, cin = x_q.shape
    cout, k, k2, wcin = w_q.shape
    if k not in (1, 3) or k2 != k or wcin != cin or stride not in (1, 2):
        raise ValueError(f"conv_int8: x {tuple(x_q.shape)}, w {tuple(w_q.shape)}, "
                         f"stride {stride}: need k in (1, 3), stride in (1, 2)")
    pad = k // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    tensors = {"x_q": x_q, "w_q": w_q, "w_scale": w_scale, "bias": bias,
               "inv_out": inv_out}
    dtypes = {"x_q": torch.int8, "w_q": torch.int8, "w_scale": torch.float32,
              "bias": torch.float32, "inv_out": torch.float32,
              "skip_q": torch.int8, "skip_s": torch.float32}
    if skip_q is not None:
        tensors.update(skip_q=skip_q, skip_s=skip_s)
        if skip_q.shape != (b, ho, wo, cout):
            raise ValueError(f"conv_int8: skip {tuple(skip_q.shape)} != output "
                             f"{(b, ho, wo, cout)}")
    for key in ("w_scale", "bias", "inv_out", "skip_s"):
        if key in tensors and tensors[key].shape != (cout,):
            raise ValueError(f"conv_int8: {key} must have shape ({cout},)")
    dev = _check_cuda("conv_int8", tensors, dtypes)
    out = torch.empty((b, ho, wo, cout), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    from face_vijnana_yolov3_tpu_torch import kernels

    lib = kernels.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.fvy_conv_int8(
            x_q.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
            None if skip_q is None else skip_q.data_ptr(),
            None if skip_s is None else skip_s.data_ptr(),
            inv_out.data_ptr(), out.data_ptr(),
            b, h, w, cin, cout, k, stride, int(leaky), stream,
        )
    if rc != 0:
        raise RuntimeError(f"conv_int8: kernel launch failed, CUDA error {rc}")
    conv_int8.launches += 1
    return out


conv_int8.launches = 0  # kernel launches, counted where the kernel launches
