"""Detection mAP harness — parity oracle for solution_fd.csv.

A copy of face_vijnana_yolov3_tpu/evals/detection.py (the port imports
nothing of the JAX package); tests/test_torch_evals.py holds it to the
original, source and results. One change: the per-image matching is its
own function, `match_images` (a bootstrap over images needs it), and
`match_solution` concatenates its images.

Reproduces the reference's cal_mAP_fd (reference src/space/evaluate.py:27-127)
semantics exactly:

* per GT image: all-pairs IoU between GT boxes (x, y, x+w, y+h — note no -1) and
  that image's solution rows (cols 1..5 = x, y, w, h, score);
* pairs with IoU > 0 pooled and greedily assigned in descending-IoU order, each
  GT and each prediction used at most once (:85-96);
* only images that produced at least one positive-IoU pair contribute their
  solution rows to the P-R pool — unmatched images' predictions silently drop
  (the reference's `continue` at :77 fires before rows are accumulated; quirk
  preserved);
* global confidence-descending sweep accumulates cumulative precision/recall with
  gt_count = ALL GT rows (:103-119);
* AP = scipy quad over the scipy interp1d(recall → precision) interpolant
  between rs[0] and rs[-1] (:124-126).

Divergence: an empty matched pool raises a ValueError with a clear message where
the reference would die with an unbound-variable/pandas error.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def _pairwise_iou_np(gt_boxes: np.ndarray, sol_boxes: np.ndarray) -> np.ndarray:
    """(G,4)x(P,4) interval-overlap IoU (bbox_iou semantics)."""
    a = gt_boxes[:, None, :]
    b = sol_boxes[None, :, :]
    iw = np.maximum(
        0.0, np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0])
    )
    ih = np.maximum(
        0.0, np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1])
    )
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return inter / union


def _greedy_assign(ious: np.ndarray) -> dict[int, float]:
    """Greedy desc-IoU assignment over positive pairs; returns {pred_j: iou}."""
    gi, pj = np.nonzero(ious > 0.0)
    if gi.size == 0:
        return {}
    vals = ious[gi, pj]
    order = np.argsort(-vals, kind="stable")
    used_g: set[int] = set()
    used_p: set[int] = set()
    out: dict[int, float] = {}
    for k in order:
        i, j = int(gi[k]), int(pj[k])
        if i in used_g or j in used_p:
            continue
        out[j] = float(vals[k])
        used_g.add(i)
        used_p.add(j)
    return out


def match_images(gt_path: str, sol_path: str):
    """Run the per-image greedy matching once, image by image; returns
    (matches, gt_counts).

    For each GT image, in the reference's order, `matches` holds (scores,
    ious): that image's solution rows' confidences and assigned IoUs (-1
    when unassigned), or two empty arrays where the image adds nothing to
    the P-R pool (no solution rows, or no pair with a positive IoU: the
    reference's quirk). `gt_counts` holds each image's GT face count.
    Keeping the images apart lets a bootstrap resample them.
    """
    try:
        sol_df = pd.read_csv(sol_path, header=None)
    except pd.errors.EmptyDataError:
        # An undertrained/over-thresholded run writes zero rows; surface the
        # same clear no-pairs error as match_solution instead of a raw
        # pandas crash.
        raise ValueError(
            f"solution file {sol_path!r} is empty — no detections to score "
            "(the reference would crash here)"
        ) from None
    gt_df = pd.read_csv(gt_path)
    sol_groups = sol_df.groupby(0)
    gt_groups = gt_df.groupby("FILE")

    matches: list[tuple[np.ndarray, np.ndarray]] = []
    gt_counts: list[int] = []
    nothing = (np.zeros(0), np.zeros(0))
    for image_id in list(gt_groups.groups.keys()):
        df = gt_groups.get_group(image_id)
        gt_counts.append(df.shape[0])
        try:
            rel = sol_groups.get_group(image_id)
        except KeyError:
            matches.append(nothing)
            continue
        gt_boxes = np.stack(
            [
                df.iloc[:, 3].to_numpy(float),
                df.iloc[:, 4].to_numpy(float),
                df.iloc[:, 3].to_numpy(float) + df.iloc[:, 5].to_numpy(float),
                df.iloc[:, 4].to_numpy(float) + df.iloc[:, 6].to_numpy(float),
            ],
            axis=1,
        )
        sol_boxes = np.stack(
            [
                rel.iloc[:, 1].to_numpy(float),
                rel.iloc[:, 2].to_numpy(float),
                rel.iloc[:, 1].to_numpy(float) + rel.iloc[:, 3].to_numpy(float),
                rel.iloc[:, 2].to_numpy(float) + rel.iloc[:, 4].to_numpy(float),
            ],
            axis=1,
        )
        pair_ious = _pairwise_iou_np(gt_boxes, sol_boxes)
        pair_ious = np.nan_to_num(pair_ious, nan=0.0, posinf=0.0, neginf=0.0)
        assigned = _greedy_assign(pair_ious)
        if not assigned:
            matches.append(nothing)  # reference quirk: image contributes nothing at all (:77)
            continue
        row_ious = np.full(rel.shape[0], -1.0)
        for j, v in assigned.items():
            row_ious[j] = v
        matches.append((rel.iloc[:, 5].to_numpy(float), row_ious))
    return matches, np.asarray(gt_counts)


def match_solution(gt_path: str, sol_path: str):
    """Run the per-image greedy matching once; returns (scores, ious, gt_count).

    `scores`/`ious` are the pooled solution rows' confidences and assigned IoUs
    (-1 when unassigned), in the reference's accumulation order: the images
    of `match_images`, concatenated. Splitting the matching from the
    threshold sweep lets the IoU-threshold loop (0.50:0.05:0.95) reuse one
    matching pass — the assignment is threshold-free in the reference too.
    """
    matches, gt_counts = match_images(gt_path, sol_path)
    if not any(s.size for s, _ in matches):
        raise ValueError(
            "no GT/solution pairs with positive IoU — nothing to score "
            "(the reference would crash here)"
        )
    scores = np.concatenate([s for s, _ in matches])
    ious = np.concatenate([i for _, i in matches])
    return scores, ious, int(gt_counts.sum())


def pr_curve(scores: np.ndarray, ious: np.ndarray, gt_count: int, iou_th: float):
    """Confidence-descending cumulative P-R (evaluate.py:103-119)."""
    order = np.argsort(-scores, kind="stable")
    tp = np.cumsum(ious[order] >= iou_th)
    count = np.arange(1, scores.shape[0] + 1)
    ps = tp / count
    rs = tp / gt_count
    return ps, rs


def average_precision(ps: np.ndarray, rs: np.ndarray) -> float:
    """AP = quad(interp1d(rs, ps), rs[0], rs[-1]) — the reference's integrator
    (evaluate.py:124-126), warnings and all."""
    from scipy.interpolate import interp1d
    from scipy.integrate import quad

    func = interp1d(rs, ps)
    return float(quad(lambda x: func(x), rs[0], rs[-1])[0])


def cal_mAP_fd(gt_path: str, sol_path: str, iou_th: float):
    """One-threshold AP (reference signature); returns (ps, rs, mAP)."""
    scores, ious, gt_count = match_solution(gt_path, sol_path)
    ps, rs = pr_curve(scores, ious, gt_count, iou_th)
    return ps, rs, average_precision(ps, rs)


def map_sweep(gt_path: str, sol_path: str, out_h5: str | None = "p_r_curve.h5"):
    """The reference main's IoU sweep 0.50:0.05:0.95 → p_r_curve.h5
    (evaluate.py:337-356). Returns (ps_ls, rs_ls, mAP_ls)."""
    scores, ious, gt_count = match_solution(gt_path, sol_path)
    ps_ls, rs_ls, map_ls = [], [], []
    for iou_th in np.arange(0.5, 1.0, 0.05):
        ps, rs = pr_curve(scores, ious, gt_count, iou_th)
        ap = average_precision(ps, rs)
        print(f"{iou_th:1.2f}", ap)
        ps_ls.append(ps)
        rs_ls.append(rs)
        map_ls.append(ap)
    if out_h5 is not None:
        import h5py

        with h5py.File(out_h5, "w") as f:
            f["ps_ls"] = np.asarray(ps_ls)
            f["rs_ls"] = np.asarray(rs_ls)
            f["mAP_ls"] = np.asarray(map_ls)
    return np.asarray(ps_ls), np.asarray(rs_ls), np.asarray(map_ls)


def plot_pr_curves(h5_path: str = "p_r_curve.h5",
                   out_png: str = "p_v_curve.png"):
    """Render p_r_curve.h5 → the reference's published P-R figure.

    The reference README ships pics/p_v_curve.png (README.md:177-180) but no
    code to regenerate it from the p_r_curve.h5 its eval CLI writes
    (reference src/space/evaluate.py:353-356) — this is the producer: one
    matplotlib line per IoU threshold 0.50:0.05:0.95, recall on x, precision
    on y, threshold legend, same title/axis labels as the published figure.
    """
    import h5py
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with h5py.File(h5_path, "r") as f:
        ps_ls = np.asarray(f["ps_ls"])
        rs_ls = np.asarray(f["rs_ls"])

    fig, ax = plt.subplots(figsize=(11.69, 6.06))
    for ps, rs, iou_th in zip(ps_ls, rs_ls, np.arange(0.5, 1.0, 0.05)):
        ax.plot(rs, ps, label=f"{iou_th:.2f}", linewidth=1.2)
    ax.set_title("Precision vs. recall according to IoU threshold.",
                 fontsize=10)
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.grid(True)
    ax.legend(loc="lower right", fontsize=8)
    fig.savefig(out_png, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_png
