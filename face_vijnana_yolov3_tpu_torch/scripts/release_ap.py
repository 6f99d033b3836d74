"""Held-out AP of a release checkpoint at each serving precision, with
bootstrap intervals.

Serves the labelled val split `<workdir>/valset` from
`<workdir>/<ckpt_name>.pt` in test mode the way serving runs it: float32;
bfloat16 with `bf16_f32_front="auto"` (the guard depth probed on this
checkpoint, as the JAX bench's AP pass does); int8 with the default
self-check, which takes the checkpoint's pinned `int8_tail` (written by
select_serving_tail) over any heuristic. Each precision's solution CSV is
scored by the mAP harness (`evals/detection.map_sweep`: AP50 and the
AP50:95 mean), and AP50 gets a percentile bootstrap 95 % interval over the
val images: images drawn with replacement, the matching of each drawn
image kept (the harness's matching, image by image:
`evals/detection.match_images`).

Usage: python -m face_vijnana_yolov3_tpu_torch.scripts.release_ap
       [workdir] [ckpt_name] [--resamples 1000] [--device DEV]

Prints a line per precision and one JSON object last.
"""

from __future__ import annotations

import argparse
import json
import os
import warnings

import numpy as np

from face_vijnana_yolov3_tpu_torch.api.face_detection import resolve_device
from face_vijnana_yolov3_tpu_torch.evals.detection import (
    average_precision,
    match_images,
    pr_curve,
)
from face_vijnana_yolov3_tpu_torch.scripts import DEFAULT_WORKDIR
from face_vijnana_yolov3_tpu_torch.scripts.select_serving_tail import serve_val

PRECISIONS = ("float32", "bfloat16", "int8")
RESAMPLES = 1000


def ap50_of(matches, gt_counts, images) -> float:
    """AP at IoU 0.5 over the drawn `images` (indices, repeats allowed);
    0.0 when they hold fewer than two scored rows (no curve)."""
    scores = np.concatenate([matches[i][0] for i in images])
    if scores.size < 2:
        return 0.0
    ious = np.concatenate([matches[i][1] for i in images])
    ps, rs = pr_curve(scores, ious, int(gt_counts[images].sum()), 0.5)
    return average_precision(ps, rs)


def bootstrap_ap50(gt_csv: str, sol_csv: str, resamples: int = RESAMPLES,
                   seed: int = 0) -> tuple[float, float]:
    """Percentile bootstrap 95 % interval of AP50 over the GT images;
    (0.0, 0.0) for an empty solution CSV."""
    try:
        matches, gt_counts = match_images(gt_csv, sol_csv)
    except ValueError as e:
        if "to score" not in str(e):
            raise
        return 0.0, 0.0
    rng = np.random.default_rng(seed)
    n = len(matches)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # quad's subdivision warnings, as the harness's
        aps = [ap50_of(matches, gt_counts, rng.integers(0, n, n))
               for _ in range(resamples)]
    lo, hi = np.percentile(aps, [2.5, 97.5])
    return float(lo), float(hi)


def measure(workdir: str, ckpt_name: str, precision: str, *, device=None,
            resamples: int = RESAMPLES) -> dict:
    """Serve the val split at `precision` (`serve_val`); returns {"ap50",
    "map", "ci95", "rows", and "guard_depth" (bf16) or "int8_tail"
    (int8)}."""
    fd, sol, maps = serve_val(workdir, ckpt_name, precision, f"release_{precision}",
                              device=device)
    with open(sol) as f:
        out = {"rows": sum(1 for _ in f)}
    if precision == "bfloat16":
        out["guard_depth"] = fd._bf16_front_depth()
    if precision == "int8":
        out["int8_tail"] = int(fd.int8_tail_chosen)
    gt = os.path.join(workdir, "valset", "validation.csv")
    out.update(ap50=float(maps[0]), map=float(np.mean(maps)),
               ci95=bootstrap_ap50(gt, sol, resamples))
    return out


def parse_args(argv: list[str] | None):
    p = argparse.ArgumentParser(
        prog="python -m face_vijnana_yolov3_tpu_torch.scripts.release_ap",
        description="Held-out AP at each serving precision, with bootstrap intervals.")
    p.add_argument("workdir", nargs="?", default=DEFAULT_WORKDIR)
    p.add_argument("ckpt_name", nargs="?", default="fd_ckpt_qat")
    p.add_argument("--resamples", type=int, default=RESAMPLES)
    p.add_argument("--device", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Measure every precision; returns {precision: measure(...)}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    out = {}
    for precision in PRECISIONS:
        r = out[precision] = measure(args.workdir, args.ckpt_name, precision,
                                     device=device, resamples=args.resamples)
        extra = "".join(f", {k} {r[k]}" for k in ("guard_depth", "int8_tail") if k in r)
        print(f"[release_ap] {precision}: AP50 {r['ap50']:.4f} (95 % bootstrap "
              f"{r['ci95'][0]:.4f}-{r['ci95'][1]:.4f}, {args.resamples} resamples of "
              f"the val images), mAP {r['map']:.4f}, {r['rows']} rows{extra}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
