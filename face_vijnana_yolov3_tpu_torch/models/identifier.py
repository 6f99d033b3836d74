"""Face identifier: the Darknet-53 trunk + Dense(relu) + L2-normalize embedder.

Port of face_vijnana_yolov3_tpu/models/identifier.py:28-192: (B, S, S, 3)
NHWC → trunk conv_0..73 → Flatten (13·13·1024 = 173,056 at 416²) →
Dense(dense1_dim = 64, relu) → L2 normalize (eps 1e-12); triplets stack
anchor, positive and negative into one batch of 3B images for one trunk
pass, and train on mean(max(‖a−p‖ − ‖a−n‖ + 0.2, 0)).

Flatten order: Keras flattens (H, W, C) row-major and dense1's rows follow
that order. The trunk runs NCHW inside, so the feature is flattened from
its NHWC view (`dense_l2norm`); `dense1.weight` is the Keras kernel
transposed, (dense1_dim, flat), its columns in (H, W, C) order.

Forwards, as in the JAX package: the module's own `embed` (eval
BatchNorm, f32), `embed_train` (batch-statistics BatchNorm, f32 or bf16
mixed precision, fake-quant, remat: the training forward), `embed_folded`
(BN folded, bf16 with the f32 front guard) and `embed_quant` (the int8
trunk through kernel A0 on every conv, never the block kernel A, and a
bf16 dense1), the last three on explicit param dicts.

Precision: the f32 dense1 matmul runs with TF32 off (JAX
Precision.HIGHEST); the bf16 dense1 is a bf16 product whose result is
rounded to bf16 before the f32 bias is added (a bf16 dot with no
preferred type in the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from face_vijnana_yolov3_tpu_torch.models import darknet, quant

TRIPLET_ALPHA = 0.2  # reference ALPHA (face_identification.py:67)
L2_NORM_EPS = 1e-12  # K.l2_normalize epsilon


def init_dense1(seed: int, flat_dim: int, dense1_dim: int) -> dict:
    """dense1 in the JAX layout ({"kernel" (flat, D), "bias" (D,)}): a
    uniform(±sqrt(6 / (flat + D))) kernel from `np.random.default_rng(seed)`,
    draw for draw the JAX `FaceIdentifierModel.init` given the same seed
    (identifier.py:35-50), and a zero bias."""
    limit = float(np.sqrt(np.float32(6.0 / (flat_dim + dense1_dim))))
    np_rng = np.random.default_rng(seed)
    return {
        "kernel": np_rng.uniform(-limit, limit, (flat_dim, dense1_dim)).astype(np.float32),
        "bias": np.zeros((dense1_dim,), np.float32),
    }


def dense_l2norm(dense: dict, feat: torch.Tensor, compute_dtype,
                 tp=None) -> torch.Tensor:
    """(B, h, w, C) NHWC trunk feature → (B, D) f32 unit embeddings:
    Flatten (H, W, C), dense1 in `compute_dtype` (f32 with TF32 off; bf16
    operands with a bf16 result), + the f32 bias, relu, L2 normalize
    (identifier.py:98-118). `dense` holds "weight" (D, flat) and "bias".

    tp = (model group, rows): tensor parallelism. "weight" then holds only
    the kernel rows `rows` of the flattened feature (columns of the
    transposed kernel); this rank multiplies its slice of the feature and
    the partial products are summed over the group (forward all-reduce,
    backward identity), the bias added once after. The feature's gradient
    is summed over the group in the backward (each rank's covers its rows),
    so the replicated trunk gets the whole gradient on every model rank."""
    flat = feat.reshape(feat.shape[0], -1).to(compute_dtype)
    if tp is not None:
        from face_vijnana_yolov3_tpu_torch.parallel.mesh import sum_backward

        flat = sum_backward(flat, tp[0])[:, tp[1]]
    with darknet.exact_f32():
        h = flat @ dense["weight"].to(compute_dtype).t()
    if tp is not None:
        from face_vijnana_yolov3_tpu_torch.parallel.mesh import sum_forward

        h = sum_forward(h, tp[0])
    h = torch.relu(h.float() + dense["bias"].float())
    norm = torch.sqrt(torch.clamp_min(torch.sum(h * h, dim=-1, keepdim=True),
                                      L2_NORM_EPS))
    return h / norm


class FaceIdentifierModel(darknet.Darknet):
    """The trunk's modules plus `dense1`, under the JAX tree's key names."""

    def __init__(self, image_size: int = 416, dense1_dim: int = 64, device=None):
        super().__init__(darknet.trunk_graph(), device=device)
        self.image_size = image_size
        self.dense1_dim = dense1_dim
        self.flat_dim = (image_size // 32) ** 2 * 1024
        self.dense1 = nn.Linear(self.flat_dim, dense1_dim, device=device)
        self.requires_grad_(False)

    # -------------------------------------------------------------- params

    def init_params(self, seed: int):
        """Random (params, state) numpy trees in the JAX layout: the trunk
        from `seed`, dense1 from `seed + 1`. The JAX init derives its two
        numpy seeds from a split key instead; handed those two seeds,
        `darknet.init_graph_params` and `init_dense1` give its trees."""
        params, state = darknet.init_graph_params(self.ops, seed)
        params["dense1"] = init_dense1(seed + 1, self.flat_dim, self.dense1_dim)
        return params, state

    def init_from_darknet(self, weights_path: str, seed: int) -> dict:
        """Pretrained trunk from a darknet .weights file + a fresh dense1
        (identifier.py:52-58): a state dict to `load_state_dict`."""
        from face_vijnana_yolov3_tpu_torch.convert import identifier_params_from_jax
        from face_vijnana_yolov3_tpu_torch.core.weights import load_darknet_weights

        sd = {k: torch.from_numpy(v)
              for k, v in load_darknet_weights(weights_path, self.ops).items()}
        sd.update(identifier_params_from_jax(
            {"dense1": init_dense1(seed + 1, self.flat_dim, self.dense1_dim)}, {}))
        return sd

    # -------------------------------------------------------------- forward

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) NHWC f32 → (B, D) unit embeddings, eval BatchNorm
        in f32 (the fid extractor)."""
        with darknet.exact_f32():
            feat = self.run_nchw(x.permute(0, 3, 1, 2).contiguous())["trunk"]
        dense = {"weight": self.dense1.weight, "bias": self.dense1.bias}
        return dense_l2norm(dense, feat.permute(0, 2, 3, 1), torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embed(x)

    def embed_train(self, params: dict, state: dict, x: torch.Tensor, *,
                    compute_dtype=torch.float32, bn_momentum=None,
                    fakequant: bool = False, remat: bool | int = False,
                    group=None, tp=None):
        """Training forward (identifier.py:60-95): (B, S, S, 3) NHWC →
        ((B, D) f32 unit embeddings, new BN state). params/state are
        state-dict-named tensors (`darknet.split_state_dict`); dense1 runs
        in `compute_dtype` and is never fake-quantized (the deployed int8
        program serves a bf16 dense1). group: the data-parallel process
        group (darknet.apply_graph_train); tp: dense1's tensor parallelism
        (`dense_l2norm`)."""
        outs, new_state = darknet.apply_graph_train(
            params, state, x, self.ops, compute_dtype=compute_dtype,
            bn_momentum=bn_momentum, fakequant=fakequant, remat=remat, group=group)
        dense = {"weight": params["dense1.weight"], "bias": params["dense1.bias"]}
        return dense_l2norm(dense, outs["trunk"], compute_dtype, tp=tp), new_state

    def apply_train(self, params: dict, state: dict, x: torch.Tensor, **kw):
        """`embed_train` under the name train/trainer.finalize_bn_stats calls."""
        return self.embed_train(params, state, x, **kw)

    def triplet_forward(self, params: dict, state: dict, anchors, positives, negatives,
                        *, compute_dtype=torch.float32, remat: bool | int = False,
                        fakequant: bool = False, group=None, tp=None):
        """One trunk pass over the stacked [a; p; n] batch (BatchNorm
        statistics over all 3B images) → ((B, 3D) [ea | ep | en], new
        state) (identifier.py:168-180). group / tp: `embed_train`."""
        b = anchors.shape[0]
        stacked = torch.cat([anchors, positives, negatives], dim=0)
        emb, new_state = self.embed_train(params, state, stacked,
                                          compute_dtype=compute_dtype,
                                          fakequant=fakequant, remat=remat,
                                          group=group, tp=tp)
        return torch.cat([emb[:b], emb[b:2 * b], emb[2 * b:]], dim=-1), new_state

    @staticmethod
    def triplet_loss(y_pred: torch.Tensor, alpha: float = TRIPLET_ALPHA,
                     dim: int = 64) -> torch.Tensor:
        """mean(max(‖a−p‖ − ‖a−n‖ + α, 0)) over the batch (identifier.py:
        182-192)."""
        a, p, n = y_pred[:, :dim], y_pred[:, dim:2 * dim], y_pred[:, 2 * dim:3 * dim]
        d_ap = torch.sqrt(torch.sum(torch.square(a - p), dim=-1))
        d_an = torch.sqrt(torch.sum(torch.square(a - n), dim=-1))
        return torch.mean(torch.clamp_min(d_ap - d_an + alpha, 0.0))

    # ---------------------------------------------------------- folded / int8

    def fold(self) -> dict:
        """Folded params of this module's weights (identifier.py:97-101):
        {"conv_{i}": {"kernel" OIHW, "bias"}, "dense1": {"weight", "bias"}}."""
        folded = darknet.fold_graph_params(self.state_dict(), self.ops)
        folded["dense1"] = {"weight": self.dense1.weight.detach().clone(),
                            "bias": self.dense1.bias.detach().clone()}
        return folded

    def embed_folded(self, folded: dict, x: torch.Tensor, *,
                     compute_dtype=torch.bfloat16, f32_front_blocks: int = 0):
        """Folded trunk + dense1 (identifier.py:120-142); f32_front_blocks
        keeps the first N graph segments f32 (the input-noise guard of
        darknet.apply_graph_folded)."""
        front = (darknet.front_end_index(self.ops, f32_front_blocks)
                 if f32_front_blocks else 0)
        outs = darknet.apply_graph_folded(folded, x, self.ops,
                                          compute_dtype=compute_dtype,
                                          f32_front_ops=front)
        return dense_l2norm(folded["dense1"], outs["trunk"], compute_dtype)

    def quantize(self, folded: dict, x_calib, *, percentile=None,
                 bf16_tail_blocks: int = 0, bias_correct: bool = False) -> dict:
        """Calibrated int8 qparams for the trunk; dense1 stays bf16
        (identifier.py:144-160)."""
        qparams = quant.quantize_folded(
            {k: v for k, v in folded.items() if k != "dense1"}, x_calib, self.ops,
            percentile=percentile, bf16_tail_blocks=bf16_tail_blocks,
            bias_correct=bias_correct)
        qparams["dense1"] = {k: v.detach().cpu() for k, v in folded["dense1"].items()}
        return qparams

    def embed_quant(self, qparams: dict, x: torch.Tensor, *,
                    dense_dtype=torch.bfloat16) -> torch.Tensor:
        """int8 trunk (kernel A0 on every conv: the JAX `embed_quant` walks
        without pallas_blocks, identifier.py:162-166) + dense1 in
        `dense_dtype`."""
        qparams = quant.to_device(qparams, x.device)
        outs = quant.apply_graph_quant(qparams, x, self.ops, fused_blocks=False)
        return dense_l2norm(qparams["dense1"], outs["trunk"], dense_dtype)


def triplet_step_loss(out: torch.Tensor, weights: torch.Tensor, dim: int, *,
                      mining: str = "random", sid_a=None, sid_n=None,
                      alpha: float = TRIPLET_ALPHA, pool=None,
                      weight_sum=None) -> torch.Tensor:
    """The training loss of one triplet step (trainer.py:371-415): the
    weighted mean of max(d_ap − d_an + α, 0) over the `_pad_batch` weights.

    mining="semi_hard" re-selects each anchor's negative from the batch's
    3B embeddings: the closest with d_ap < d_an < d_ap + α among rows of
    another subject with weight > 0, else the closest harder than the
    positive, else the closest valid one (a masked (B, 3B) argmin; the
    first of tied minima, as jnp.argmin).

    Data parallel: `out` and the rest are this rank's rows; pool = (out,
    weights, sid_a, sid_n) of the whole batch, gathered in batch order (the
    semi-hard pool is all 3B global embeddings, in the global [a; p; n]
    order), and weight_sum the whole batch's weight sum, so the rank's loss
    is its share of the global weighted mean."""
    ea, ep, en = out[:, :dim], out[:, dim:2 * dim], out[:, 2 * dim:]
    d_ap = torch.sqrt(torch.sum((ea - ep) ** 2, dim=-1))
    if mining == "semi_hard":
        g_out, g_w, g_sa, g_sn = pool if pool is not None else (out, weights, sid_a,
                                                               sid_n)
        pool = torch.cat([g_out[:, :dim], g_out[:, dim:2 * dim], g_out[:, 2 * dim:]],
                         dim=0)                                    # (3B, D)
        pool_sid = torch.cat([g_sa, g_sa, g_sn])                   # (3B,)
        pool_w = torch.cat([g_w] * 3)
        d_all = torch.sqrt(torch.clamp_min(
            torch.sum((ea[:, None] - pool[None]) ** 2, dim=-1), 1e-12))  # (B, 3B)
        valid = (pool_sid[None, :] != sid_a[:, None]) & (pool_w[None, :] > 0.0)
        inf = d_all.new_full((), 1e9)  # a fill, not a host copy: capturable
        harder = valid & (d_all > d_ap[:, None])
        semi = harder & (d_all < d_ap[:, None] + alpha)
        cand = torch.where(
            semi.any(-1)[:, None], torch.where(semi, d_all, inf),
            torch.where(harder.any(-1)[:, None], torch.where(harder, d_all, inf),
                        torch.where(valid, d_all, inf)))
        en_sel = pool[torch.argmin(cand, dim=-1)]
        d_an = torch.sqrt(torch.sum((ea - en_sel) ** 2, dim=-1))
    else:  # "random": the negative TripletDataset drew
        d_an = torch.sqrt(torch.sum((ea - en) ** 2, dim=-1))
    per = torch.clamp_min(d_ap - d_an + alpha, 0.0)
    return torch.sum(per * weights) / (torch.sum(weights) if weight_sum is None
                                       else weight_sum)

