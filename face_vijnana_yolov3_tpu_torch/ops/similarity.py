"""Embedding ↔ subject-registry matching as one distance matrix.

Port of face_vijnana_yolov3_tpu/ops/similarity.py:15-45: every query
embedding is matched against the whole registry at once, ‖q‖² + ‖r‖² −
2 q·r clamped at 0, then sqrt, argmin and min. The cross term is an f32
matmul with TF32 off (`darknet.exact_f32`), the counterpart of the JAX
`Precision.HIGHEST`: TF32 keeps about three decimal digits, enough to flip
a near-tie argmin or the `sim_th` gate. `torch.argmin`, like `jnp.argmin`,
returns the first of tied minima; a NaN row gives the first NaN's index in
both.
"""

from __future__ import annotations

import torch

from face_vijnana_yolov3_tpu_torch.models.darknet import exact_f32


def match_embeddings(queries: torch.Tensor, registry: torch.Tensor):
    """(Q, D) queries vs (R, D) registry rows → (best_idx (Q,) int32,
    best_dist (Q,) f32): each query's nearest registry row by L2 distance
    and that distance (compare it against hps['sim_th'])."""
    q = queries.float()
    r = registry.float().to(q.device)
    q2 = torch.sum(q * q, dim=-1, keepdim=True)        # (Q, 1)
    r2 = torch.sum(r * r, dim=-1)[None, :]             # (1, R)
    with exact_f32():
        cross = q @ r.t()
    dist = torch.sqrt(torch.clamp_min(q2 + r2 - 2.0 * cross, 0.0))
    return torch.argmin(dist, dim=-1).to(torch.int32), torch.amin(dist, dim=-1)
