"""Plain PyTorch reference of identification: a face box's crop of the
frame, its cubic letterbox, the identifier's int8 embed and the match
against a registry of embeddings.

A frozen copy of the plain arithmetic of face_vijnana_yolov3_tpu_torch (it
imports nothing of it): the reference's crop window `image[(t - 1):(b - 1),
(l - 1):(r - 1)]` with python's slice rules (ops/roi.roi_window), the crop
* (1/255) resized by the cv2 cubic letterbox (here the crop itself is
resized, where the program gathers a window of the staged frame and
contracts over it), the folded trunk quantized and calibrated ("auto") on
the first 16 images the identifier embeds and walked in int8 (the
detector reference's functions), dense1 as a bf16 product rounded to bf16
before the f32 bias, relu, L2 normalisation (models/identifier.
dense_l2norm), and ops/similarity.match_embeddings' distances.
"""

from __future__ import annotations

import numpy as np
import torch

from fvy_bench.reference import detector as det

L2_NORM_EPS = 1e-12
CALIB_IMAGES = 16


class Embedder:
    """The identifier's served embed at int8 (`qmax` 127; 7 is the int4
    control), calibrated on the first images it embeds."""

    def __init__(self, arch: dict, sd: dict, *, qmax: int = 127):
        self.arch, self.qmax = arch, qmax
        self.ops = det.trunk_ops(arch)
        self.folded = det.fold(sd, self.ops)
        self.dense = (sd["dense1.weight"], sd["dense1.bias"])
        self.q = None

    @torch.no_grad()
    def embed(self, x: torch.Tensor, block: int = 64) -> torch.Tensor:
        """(N, S, S, 3) f32 crops → (N, D) f32 unit embeddings."""
        if self.q is None:
            scales = det.calibrate(self.folded, x[:CALIB_IMAGES], self.ops, self.qmax)
            self.q = det.quantize_folded(self.folded, scales, self.ops, 0, self.qmax)
        out = []
        for s in range(0, x.shape[0], block):
            feat = det.apply_quant(self.q, x[s:s + block], self.ops, self.qmax)
            flat = feat.reshape(feat.shape[0], -1).to(torch.bfloat16)
            h = flat @ self.dense[0].to(torch.bfloat16).t()
            h = torch.relu(h.float() + self.dense[1].float())
            out.append(h / torch.sqrt(torch.clamp_min(torch.sum(h * h, -1, keepdim=True),
                                                      L2_NORM_EPS)))
        return torch.cat(out)


def crop(frame_u8: torch.Tensor, box, s: int) -> torch.Tensor | None:
    """The letterboxed (S, S, 3) f32 crop of one box [xmin, ymin, xmax,
    ymax] of a (H, W, 3) uint8 frame, or None for an empty crop."""
    l, t, r, b = (int(v) for v in box[:4])
    h, w = frame_u8.shape[:2]
    ys = range(h)[slice(t - 1, b - 1)]
    xs = range(w)[slice(l - 1, r - 1)]
    if len(ys) <= 0 or len(xs) <= 0:
        return None
    c = frame_u8[ys.start:ys.stop, xs.start:xs.stop]
    return det.letterbox(c[None], det.geometry(c.shape[0], c.shape[1], s), s)[0]


def distances(queries: torch.Tensor, registry: torch.Tensor) -> torch.Tensor:
    """(Q, R) L2 distances, ‖q‖² + ‖r‖² - 2 q·r clamped at 0, TF32 off."""
    q2 = torch.sum(queries * queries, -1, keepdim=True)
    r2 = torch.sum(registry * registry, -1)[None, :]
    with det.exact_f32():
        cross = queries @ registry.t()
    return torch.sqrt(torch.clamp_min(q2 + r2 - 2.0 * cross, 0.0))


def id_gap(program_ids: list, dist: np.ndarray, sim_th: float) -> float:
    """The widest gap by which the registry row the program chose for an
    ROI lies farther from the reference's embedding of its crop than the
    reference's nearest row. An ROI the program left without a row where
    the reference writes one (its nearest row within sim_th), or the
    reverse, reads 2, the largest distance between unit vectors."""
    worst = 0.0
    for pid, d in zip(program_ids, dist, strict=True):
        ref_row = float(d.min()) <= sim_th
        if pid is None or not ref_row:
            gap = 0.0 if (pid is None) == (not ref_row) else 2.0
        else:
            gap = float(d[pid] - d.min())
        worst = max(worst, gap)
    return worst
