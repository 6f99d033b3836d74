"""Face reconstruction decoder (experimental, reference C24 parity).

Port of face_vijnana_yolov3_tpu/models/recon.py. The reference inverts the
identifier: 64-d facial id → l2norm → relu → dense1ᵀ (with a RANDOM uniform
bias — a reference quirk, src/space/face_identification.py:1179-1180) →
reshape 13x13x1024 → a mirrored chain of transposed convolutions sharing the
trunk conv kernels, each preceded by leaky → channel l2norm → a *fresh*
BatchNorm clone, with `subtract` skip inversions per residual block and
stride-2 transposes at the five downsampling stages
(face_identification.py:1155-1488). Gated by conf `face_vijana_recon_load`.

The decoder graph is generated by walking the trunk IR in reverse
(`recon_graph`). Activations run NCHW inside; `forward` takes (B, D) ids and
returns NHWC images like the JAX apply.

`jax.lax.conv_transpose(padding="SAME", transpose_kernel=True)` with k=3,
s=2 pads 2 before and 1 after the dilated input: that is
`conv_transpose2d(padding=0)` with the output cropped to [:2H, :2W].
torch's `padding=1, output_padding=1` gives the same shape one pixel
shifted, which only a value test catches (tests/test_torch_recon.py).
Stride 1 is `padding=k//2`.

State-dict names: `dense1_t.weight` (D, flat) applied as `z @ weight` (the
identifier's `dense1.weight`, shared by value), `dense1_t.bias` (flat,),
`deconv_{i}.weight` (the trunk's OIHW conv_i kernel, which is the
(in, out, k, k) layout of `conv_transpose2d` from conv_i's output
channels back to its input channels), `rbnorm_{i}.gamma/beta/mean/var`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from face_vijnana_yolov3_tpu_torch.models import darknet

# The bias seed: the JAX package draws it from np.random.default_rng(last
# word of the key data of PRNGKey(2)) (recon.py:76), and PRNGKey(2)'s key
# data is [0, 2].
RECON_SEED = 2


def recon_graph(trunk_ops=None) -> list[tuple]:
    """Reverse-walk the trunk IR into decoder ops.

    Returns ops: ('deconv', conv_idx, stride) | ('subtract',) — deconvs inside a
    residual block appear in (i, i-1) order followed by one subtract, matching
    the reference's reversed ranges.
    """
    trunk_ops = trunk_ops or darknet.trunk_graph()
    layout = {t[0]: t for t in darknet.conv_layout(trunk_ops)}
    out: list[tuple] = []
    block: list[int] | None = None
    for op in reversed(trunk_ops):
        kind = op[0]
        if kind == "add":
            block = []
        elif kind == "conv":
            idx = op[1]
            stride = layout[idx][4]
            if block is not None:
                block.append(idx)
            else:
                out.append(("deconv", idx, stride))
        elif kind == "save" and block is not None:
            for idx in block:
                out.append(("deconv", idx, layout[idx][4]))
            out.append(("subtract",))
            block = None
        # mark/output/restore: no decoder-side effect
    return out


def conv_transpose_same(h: torch.Tensor, weight: torch.Tensor, stride: int) -> torch.Tensor:
    """NCHW transposed conv with JAX's "SAME" transpose padding: the output
    is stride x the input's size."""
    k = weight.shape[-1]
    if stride == 1:
        return F.conv_transpose2d(h, weight, padding=k // 2)
    y = F.conv_transpose2d(h, weight, stride=stride)
    return y[..., : stride * h.shape[2], : stride * h.shape[3]]


def _l2norm(h: torch.Tensor, dim: int) -> torch.Tensor:
    return h / torch.sqrt(torch.clamp((h * h).sum(dim, keepdim=True), min=1e-12))


class FaceReconstructionModel(nn.Module):
    """(B, dense1_dim) facial ids → (B, image_size, image_size, 3) images."""

    def __init__(self, image_size: int = 416, dense1_dim: int = 64, device=None):
        super().__init__()
        self.image_size = image_size
        self.dense1_dim = dense1_dim
        self.trunk_ops = darknet.trunk_graph()
        self.ops = recon_graph(self.trunk_ops)
        self.grid = image_size // 32
        self.flat_dim = self.grid * self.grid * 1024
        self.layout = {t[0]: t for t in darknet.conv_layout(self.trunk_ops)}
        self.dense1_t = nn.Module()
        self.dense1_t.weight = nn.Parameter(
            torch.zeros(dense1_dim, self.flat_dim, device=device))
        self.dense1_t.bias = nn.Parameter(torch.zeros(self.flat_dim, device=device))
        for op in self.ops:
            if op[0] != "deconv":
                continue
            _, in_c, out_c, k, _s, _bn = self.layout[op[1]]
            deconv = nn.Module()
            deconv.weight = nn.Parameter(torch.zeros(out_c, in_c, k, k, device=device))
            self.add_module(f"deconv_{op[1]}", deconv)
            # The BN clone normalizes the deconv INPUT (the conv's output side).
            self.add_module(f"rbnorm_{op[1]}", darknet.BatchNormEval(out_c, device))
        self.requires_grad_(False)

    def init_state_dict(self, identifier_sd: dict, seed: int = RECON_SEED) -> dict:
        """The decoder's state dict from an identifier state dict (JAX
        `init(rng, identifier_params)`, recon.py:65-105): the trunk kernels
        shared by value, dense1ᵀ, a uniform(0, 1) bias from
        `np.random.default_rng(seed)` and fresh BNs (gamma 1, beta 0, mean 0,
        var 1). CPU tensors."""
        rng = np.random.default_rng(seed)
        sd = {"dense1_t.weight": identifier_sd["dense1.weight"].detach().cpu().clone(),
              "dense1_t.bias": torch.from_numpy(
                  rng.uniform(0.0, 1.0, (self.flat_dim,)).astype(np.float32))}
        for op in self.ops:
            if op[0] != "deconv":
                continue
            idx = op[1]
            out_c = self.layout[idx][2]
            sd[f"deconv_{idx}.weight"] = identifier_sd[f"conv_{idx}.weight"].detach().cpu().clone()
            sd[f"rbnorm_{idx}.gamma"] = torch.ones(out_c)
            sd[f"rbnorm_{idx}.beta"] = torch.zeros(out_c)
            sd[f"rbnorm_{idx}.mean"] = torch.zeros(out_c)
            sd[f"rbnorm_{idx}.var"] = torch.ones(out_c)
        return sd

    def forward(self, z: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """(B, dense1_dim) → (B, S, S, 3) NHWC, TF32 off (the JAX dense runs at
        Precision.HIGHEST). train=True normalizes with the batch statistics
        and moves the BN buffers by the Keras momentum, as the JAX apply's
        new_state."""
        with darknet.exact_f32():
            h = _l2norm(z.to(torch.float32), -1)
            h = torch.clamp(h, min=0.0)
            h = h @ self.dense1_t.weight + self.dense1_t.bias
            h = h.reshape(-1, self.grid, self.grid, 1024).permute(0, 3, 1, 2)
            skip = h
            for op in self.ops:
                if op[0] == "subtract":
                    h = h - skip
                    skip = h
                    continue
                _, idx, stride = op
                bn = getattr(self, f"rbnorm_{idx}")
                h = darknet.leaky(h)
                h = _l2norm(h, 1)
                if train:
                    mean = h.mean(dim=(0, 2, 3))
                    var = h.var(dim=(0, 2, 3), unbiased=False)
                    m = darknet.BN_MOMENTUM
                    bn.mean.copy_(bn.mean * m + mean * (1 - m))
                    bn.var.copy_(bn.var * m + var * (1 - m))
                else:
                    mean, var = bn.mean, bn.var
                scale = torch.rsqrt(var + darknet.BN_EPS) * bn.gamma
                h = (h - mean[:, None, None]) * scale[:, None, None] + bn.beta[:, None, None]
                h = conv_transpose_same(h, getattr(self, f"deconv_{idx}").weight, stride)
                if stride > 1:
                    skip = h  # strided stages reset the skip (reference :1242 etc.)
        return h.permute(0, 2, 3, 1)
