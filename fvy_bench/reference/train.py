"""Plain PyTorch reference of one f32 training step of the face detector:
the training forward (batch-statistics BatchNorm), the 3x3 head, the
weighted MSE, autograd and Keras 2.2.4's Adam.

A frozen copy of the plain arithmetic of face_vijnana_yolov3_tpu_torch
(it imports nothing of it): models/darknet.apply_graph_train without
fake-quant, models/detector.head_conv, train/trainer.detector_loss_grads
and train/optimizer.KerasAdam. f32 with TF32 off; `tf32=True` is the
control, the precision just below the configuration's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fvy_bench.reference.detector import BN_EPS, leaky, trunk_ops


def forward(params: dict, x: torch.Tensor, ops: list[tuple]) -> torch.Tensor:
    """(B, S, S, 3) NHWC → (B, S/32, S/32, C) f32 head: BatchNorm on the
    batch's statistics, var = max(E[x²] - E[x]², 0)."""
    saved = {}
    h = x.permute(0, 3, 1, 2)
    for op in ops:
        kind = op[0]
        if kind == "conv":
            _, idx, _c, k, stride, _bn, _act = op
            h = F.conv2d(h, params[f"conv_{idx}.weight"], stride=stride, padding=k // 2)
            mean = h.mean(dim=(0, 2, 3))
            var = torch.clamp_min((h * h).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            scale = torch.rsqrt(var + BN_EPS) * params[f"bnorm_{idx}.gamma"]
            h = leaky((h - mean[:, None, None]) * scale[:, None, None]
                      + params[f"bnorm_{idx}.beta"][:, None, None])
        elif kind == "save":
            saved[op[1]] = h
        elif kind == "add":
            h = saved[op[1]] + h
    feat = h.permute(0, 2, 3, 1)
    y = F.conv2d(feat.permute(0, 3, 1, 2), params["head.weight"], padding=1)
    return y.permute(0, 2, 3, 1) + params["head.bias"]


def loss_and_grads(params: dict, x, gts, weights, ops) -> tuple[torch.Tensor, dict]:
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    pred = forward(leaves, x, ops)
    per = torch.mean(torch.square(pred - gts), dim=(1, 2, 3))
    loss = torch.sum(per * weights) / torch.sum(weights)
    keys = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
    return loss.detach(), dict(zip(keys, grads))


class Adam:
    """Keras 2.2.4 Adam: lr / (1 + decay t), eps outside the bias-corrected
    square root."""

    def __init__(self, params, lr, beta_1, beta_2, decay, epsilon=1e-7):
        self.lr, self.b1, self.b2, self.decay, self.eps = lr, beta_1, beta_2, decay, epsilon
        self.t = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        t = torch.tensor(float(self.t))
        lr_t = self.lr / (1.0 + self.decay * t) if self.decay > 0 else self.lr
        a_t = (lr_t * torch.sqrt(1.0 - self.b2 ** t) / (1.0 - self.b1 ** t)).item()
        out = {}
        for k, g in grads.items():
            self.mu[k] = self.b1 * self.mu[k] + (1.0 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1.0 - self.b2) * g * g
            out[k] = params[k] - a_t * self.mu[k] / (torch.sqrt(self.nu[k]) + self.eps)
        return out


def train_steps(arch: dict, params: dict, batches: list, opt: dict, *, tf32: bool = False):
    """The reference's steps from `params` over `batches` [(images, gts,
    weights)]: (losses, first step's grads, params after the last step)."""
    ops = trunk_ops(arch)
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        adam = Adam(params, opt["lr"], opt["beta_1"], opt["beta_2"], opt["decay"])
        losses, first = [], None
        for x, gts, w in batches:
            loss, grads = loss_and_grads(params, x, gts, w, ops)
            first = grads if first is None else first
            losses.append(float(loss))
            with torch.no_grad():
                params = adam.step(params, grads)
        return losses, first, params
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
