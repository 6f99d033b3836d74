"""Face detector: truncated Darknet-53 trunk + 6-channel linear 3x3 head.

Port of face_vijnana_yolov3_tpu/models/detector.py:20-164: (B, S, S, 3) NHWC
→ trunk conv_0..73 → 3x3 'same' linear conv → (B, S/32, S/32, 6) raw [obj,
bx, by, bw, bh, score] logits, NHWC like the JAX apply. Four forwards: the
module's own (eval BatchNorm, f32), `apply_train` (batch-statistics
BatchNorm, f32 or bf16 mixed precision, optional fake-quant: the training
forward), `apply_folded` (BN folded, f32 or bf16) and `apply_quant` (int8
trunk, bf16 head), the last three on explicit param dicts as in the JAX
package. `loss` is the training loss (Keras loss='mse'); `fd_loss` the
reference's unused custom loss, carried for surface parity.

The JAX f32 path asks for Precision.HIGHEST (detector.py:26-28); the
counterpart on the card is cuDNN and cuBLAS with TF32 off, which
FaceDetectorPipeline sets (api/face_detection.py) and the folded f32 paths
set for themselves (darknet.exact_f32).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
from face_vijnana_yolov3_tpu_torch.models import darknet, quant


def init_head_params(seed: int, out_channels: int = 6) -> dict:
    """Glorot-uniform head in the JAX layout, from `np.random.default_rng(seed)`
    exactly as the JAX `FaceDetectorModel.init` draws it (detector.py:59-69)."""
    limit = float(np.sqrt(np.float32(6.0 / (3 * 3 * 1024 + out_channels))))
    np_rng = np.random.default_rng(seed)
    return {
        "kernel": np_rng.uniform(
            -limit, limit, (3, 3, 1024, out_channels)
        ).astype(np.float32),
        "bias": np.zeros((out_channels,), np.float32),
    }


class FaceDetectorModel(darknet.Darknet):
    """The trunk's modules plus `head`, under the JAX tree's key names."""

    def __init__(self, image_size: int = 416, out_channels: int = 6,
                 device=None):
        super().__init__(darknet.trunk_graph(), device=device)
        self.image_size = image_size
        self.out_channels = out_channels
        self.head = nn.Conv2d(1024, out_channels, 3, padding=1, device=device)
        self.requires_grad_(False)

    def init_params(self, seed: int):
        """Random (params, state) numpy trees in the JAX layout: the trunk
        from `seed`, the head from `seed + 1`. The JAX init derives its two
        numpy seeds from a split key instead; handed those two seeds,
        `darknet.init_graph_params` and `init_head_params` give its trees."""
        params, state = darknet.init_graph_params(self.ops, seed)
        params["head"] = init_head_params(seed + 1, self.out_channels)
        return params, state

    def init_from_darknet(self, weights_path: str, seed: int):
        """Pretrained trunk from a darknet .weights file + fresh head
        (detector.py:72-80): a state dict to `load_state_dict`."""
        from face_vijnana_yolov3_tpu_torch.core.weights import (
            load_darknet_weights,
        )

        sd = {k: torch.from_numpy(v)
              for k, v in load_darknet_weights(weights_path, self.ops).items()}
        head = params_from_jax(
            {"head": init_head_params(seed + 1, self.out_channels)}, {})
        sd.update(head)
        return sd

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) NHWC f32 → (B, S/32, S/32, out_channels) NHWC f32."""
        feat = self.run_nchw(x.permute(0, 3, 1, 2).contiguous())["trunk"]
        return self.head(feat).permute(0, 2, 3, 1)

    # -------------------------------------------------------------- training

    def apply_train(self, params: dict, state: dict, x: torch.Tensor, *,
                    compute_dtype=torch.float32, bn_momentum=None,
                    fakequant: bool = False, group=None):
        """Training forward (detector.py:82-100): (B, S, S, 3) NHWC →
        ((B, S/32, S/32, 6) f32 head, new BN state). params/state are
        state-dict-named tensors (`darknet.split_state_dict`); the head conv
        runs in `compute_dtype` and is never fake-quantized (the deployed
        int8 program serves a bf16 head). group: data-parallel process
        group (darknet.apply_graph_train)."""
        outs, new_state = darknet.apply_graph_train(
            params, state, x, self.ops, compute_dtype=compute_dtype,
            bn_momentum=bn_momentum, fakequant=fakequant, group=group)
        head = {"kernel": params["head.weight"], "bias": params["head.bias"]}
        return head_conv(outs["trunk"].to(compute_dtype), head, compute_dtype), new_state

    @staticmethod
    def loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """Keras loss='mse' (detector.py:169-173): the mean of the squared
        error over every element."""
        return torch.mean(torch.square(pred - gt))

    # -------------------------------------------------------------- folded

    def fold(self) -> dict:
        """Folded params of this module's weights (detector.py:102-105):
        {"conv_{i}": {"kernel" OIHW, "bias"}, "head": {...}} on its device."""
        folded = darknet.fold_graph_params(self.state_dict(), self.ops)
        folded["head"] = {"kernel": self.head.weight.detach().clone(),
                          "bias": self.head.bias.detach().clone()}
        return folded

    def apply_folded(self, folded: dict, x: torch.Tensor, *,
                     compute_dtype=torch.bfloat16, f32_front_blocks: int = 0):
        """Folded trunk + head (detector.py:107-122): (B, S, S, 3) → (B,
        S/32, S/32, 6) f32. f32_front_blocks keeps the first N graph
        segments f32 (darknet.apply_graph_folded)."""
        front = (darknet.front_end_index(self.ops, f32_front_blocks)
                 if f32_front_blocks else 0)
        outs = darknet.apply_graph_folded(folded, x, self.ops,
                                          compute_dtype=compute_dtype,
                                          f32_front_ops=front)
        return head_conv(outs["trunk"].to(compute_dtype), folded["head"],
                         compute_dtype)

    # -------------------------------------------------------------- int8 serving

    def quantize(self, folded: dict, x_calib: torch.Tensor, *, percentile=None,
                 bf16_tail_blocks: int = 0, act_scales=None,
                 bias_correct: bool = False, bf16_ops: tuple = ()) -> dict:
        """Calibrated int8 qparams from folded params (models/quant.py)."""
        return quant.quantize_folded(
            folded, x_calib, self.ops, percentile=percentile,
            bf16_tail_blocks=bf16_tail_blocks, act_scales=act_scales,
            bias_correct=bias_correct, bf16_ops=bf16_ops)

    def apply_quant(self, qparams: dict, x: torch.Tensor, *,
                    head_dtype=torch.bfloat16, fused_blocks: bool = False):
        """int8 trunk + bf16 head (detector.py:152-164); same (B, S/32, S/32,
        6) f32 contract. fused_blocks runs the 20 eligible residual blocks
        through the fused block kernel (ops/block_int8.py)."""
        qparams = quant.to_device(qparams, x.device)
        outs = quant.apply_graph_quant(qparams, x, self.ops,
                                       fused_blocks=fused_blocks)
        return head_conv(outs["trunk"].to(head_dtype), qparams["head"],
                         head_dtype)


def head_conv(feat: torch.Tensor, head: dict, compute_dtype) -> torch.Tensor:
    """3x3 'same' linear head conv (detector.py:20-41), NHWC: f32 with TF32
    off, or bf16 operands with a bf16 result, then + the f32 bias in f32."""
    with darknet.exact_f32():
        h = darknet.conv_nhwc(feat, head["kernel"].to(compute_dtype), 1)
    return (h + head["bias"]).float()


_K_EPSILON = 1e-7  # keras.backend.epsilon() in the reference's Keras 2.2.4


def _keras_binary_crossentropy(target: torch.Tensor, output: torch.Tensor) -> torch.Tensor:
    """K.binary_crossentropy(target, output, from_logits=False): the output
    clipped to [eps, 1 - eps], elementwise BCE (detector.py:179-185)."""
    output = torch.clamp(output, _K_EPSILON, 1.0 - _K_EPSILON)
    return -(target * torch.log(output) + (1.0 - target) * torch.log(1.0 - output))


def fd_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """The reference's custom detector loss (detector.py:188-205), defined
    there but unused by training (the parity default is `loss`, Keras
    'mse'). BCE on the raw head channels 0 and 5 as if they were
    probabilities, and mean(sqrt(square(diff))) over channels 1:5; returns
    the per-cell loss map, unreduced."""
    o_loss = _keras_binary_crossentropy(y_true[..., 0], y_pred[..., 0])
    l2_loss = torch.mean(torch.sqrt(torch.square(y_true[..., 1:5] - y_pred[..., 1:5])),
                         dim=-1)
    c_loss = _keras_binary_crossentropy(y_true[..., 5], y_pred[..., 5])
    return (o_loss + l2_loss + c_loss) / 3.0
