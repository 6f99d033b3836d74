"""The comparisons that decide `correct`: the numbers a run compares with
its plain reference, each held to the limit the cell file states."""

from __future__ import annotations

import numpy as np

# A served row matches a reference row when its score is within SCORE_TOL
# and each of its corners within `coord_tol` (the driver gives one net pixel
# in the frame's coordinates): the decode gives integer net-pixel boxes, so
# sound runs agree to the pixel, and many boxes of random weights have no
# area, which an IoU rule could not match.
SCORE_TOL = 0.05


def matches(p: np.ndarray, r: np.ndarray, coord_tol: float) -> int:
    """Pairs of rows [xmin, ymin, xmax, ymax, score] matched greedily,
    closest corners first, within coord_tol and SCORE_TOL."""
    gap = np.abs(p[:, None, :4] - r[None, :, :4]).max(axis=-1)
    gap[(gap > coord_tol) | (np.abs(p[:, None, 4] - r[None, :, 4]) > SCORE_TOL)] = np.inf
    n = 0
    while gap.size and np.isfinite(gap.min()):
        i, j = np.unravel_index(np.argmin(gap), gap.shape)
        n += 1
        gap[i, :] = np.inf
        gap[:, j] = np.inf
    return n


def box_miss(program: list[np.ndarray], reference: list[np.ndarray],
             coord_tol: float) -> float:
    """1 - the micro F1 of the program's rows against the reference's over
    the frames compared (`matches`): 0 when every row of each side has its
    partner on the other; a frame that the program left without rows, or
    whose rows are wrong, misses them all."""
    matched, total = 0, 0
    for p, r in zip(program, reference, strict=True):
        total += len(p) + len(r)
        if len(p) and len(r):
            matched += matches(p, r, coord_tol)
    return 1.0 - 2.0 * matched / total if total else 0.0


def worst_leaf_gap(prog: dict, ref: dict, keep: set[str]) -> float:
    """max over the leaves in `keep` of |‖prog leaf‖ - ‖ref leaf‖| over the
    larger of the reference leaf's norm and the median leaf's."""
    norms = {k: float(np.linalg.norm(ref[k])) for k in keep}
    median = float(np.median(list(norms.values())))
    return max(abs(float(np.linalg.norm(prog[k])) - norms[k]) / max(norms[k], median)
               for k in keep)


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); a
    number that is not finite fails."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in out.values())
    return ok, out
