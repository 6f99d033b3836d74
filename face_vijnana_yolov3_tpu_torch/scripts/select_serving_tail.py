"""Release-time int8 serving-tail selection: measure, then pin the artifact.

Port of scripts/select_serving_tail.py (the JAX repo's tooling). The
label-free box-F1 self-check cannot resolve the int8 / bf16-tail frontier
of a QAT-trained checkpoint, and the frontier is not monotonic in the tail
depth; one held-out AP50 measurement per candidate can. This tool serves
the labelled val split `<workdir>/valset` (the JPEGs and validation.csv)
from `<workdir>/<ckpt_name>.pt` at f32 and at each candidate tail, picks
the fastest tail whose AP50 drift against f32 clears `drift_bar`
(throughput falls with the tail's depth), else the best one, and writes the
choice into the checkpoint's trainmeta sidecar (`int8_tail`, with the
table), which `FaceDetectorPipeline.calibrate_int8` honours over any
heuristic. Run it on the finished artifact: the trainer's saves rewrite the
sidecar.

Usage: python -m face_vijnana_yolov3_tpu_torch.scripts.select_serving_tail
       [workdir] [ckpt_name] [--tails 0,3,4,5,6,8] [--drift-bar -0.02]
       [--device DEV]

Differences from the JAX script: when no candidate clears the bar, the
fallback ranks the unrounded APs (the JAX script compares a candidate's
unrounded AP with the best's rounded table entry, which can rank a
candidate above a better one less than 5e-5 away); the table stays
rounded to 4 places. And a solution CSV with rows but none on a face
scores 0.0 where the JAX script's map_sweep raises.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from face_vijnana_yolov3_tpu_torch.api.config import FdConf
from face_vijnana_yolov3_tpu_torch.api.face_detection import (
    FaceDetectorPipeline,
    resolve_device,
)
from face_vijnana_yolov3_tpu_torch.core.checkpoints import update_train_meta
from face_vijnana_yolov3_tpu_torch.evals.detection import map_sweep
from face_vijnana_yolov3_tpu_torch.scripts import DEFAULT_WORKDIR, ckpt_path

DRIFT_BAR = -0.02
CANDIDATE_TAILS = (0, 3, 4, 5, 6, 8)  # throughput order, fastest first


def serve_val(workdir: str, ckpt_name: str, precision: str, tag: str, *,
              tail: int | None = None, device=None):
    """Serve the val split in test mode from the checkpoint at `precision`
    into `<workdir>/solution_<tag>.csv`, and score it; returns (the
    pipeline, the CSV's path, map_sweep's 10 APs over IoU 0.50:0.95).

    int8 with `tail` None runs the self-check, which takes the checkpoint's
    pin; an int `tail` serves that many bf16 tail blocks (0 = full int8)
    with no self-check. bfloat16 probes its guard depth on the checkpoint
    (`bf16_f32_front="auto"`), as serving does. A CSV with no detection,
    or none overlapping a face, scores 0.0 at every threshold.
    """
    valdir = os.path.join(workdir, "valset")
    sol = os.path.join(workdir, f"solution_{tag}.csv")
    conf = FdConf(
        test_path=valdir,
        output_file_path=sol,
        weights_path="missing.weights",
        model_path=ckpt_path(workdir, ckpt_name),
        model_loading=True,
    )
    if tail is not None:
        conf.int8_bf16_tail = int(tail)
        conf.int8_tail_auto = False  # explicit candidate, no escalation
    if precision == "bfloat16":
        conf.bf16_f32_front = "auto"
    fd = FaceDetectorPipeline(conf, precision=precision, device=device)
    fd.test()
    try:
        _, _, maps = map_sweep(os.path.join(valdir, "validation.csv"), sol, out_h5=None)
    except ValueError as e:
        if "to score" not in str(e):
            raise
        maps = np.zeros(10)
    return fd, sol, maps


def measure_tail_ap(workdir: str, ckpt_name: str, tail: int | None, *,
                    device=None) -> float:
    """Held-out AP50 of test mode at one explicit configuration: tail None
    = float32; tail >= 0 = int8 with that many bf16 tail blocks (0 = full
    int8), no self-check. An empty solution CSV (nothing cleared
    face_conf_th) scores 0.0, and so does one with no row on a face (the
    JAX script raises there)."""
    precision, tag = ("float32", "f32") if tail is None else ("int8", f"tail{tail}")
    _, _, maps = serve_val(workdir, ckpt_name, precision, f"seltail_{tag}", tail=tail,
                           device=device)
    return float(maps[0])


def select_tail(workdir: str, ckpt_name: str, tails=CANDIDATE_TAILS,
                drift_bar: float = DRIFT_BAR, f32_ap50: float | None = None,
                log=print, *, device=None) -> tuple[int, dict[int, float]]:
    """Walk `tails` fastest first; return (tail, table) at the first
    candidate whose AP50 drift against f32 clears `drift_bar`, else the
    candidate with the best AP50 (table: tail -> AP50 rounded to 4
    places)."""
    if f32_ap50 is None:
        f32_ap50 = measure_tail_ap(workdir, ckpt_name, None, device=device)
        log(f"[select_tail] f32 AP50 {f32_ap50:.4f}")
    table: dict[int, float] = {}
    best = best_ap = None
    for t in tails:
        ap = measure_tail_ap(workdir, ckpt_name, t, device=device)
        table[int(t)] = round(ap, 4)
        drift = ap - f32_ap50
        log(f"[select_tail] tail {t}: AP50 {ap:.4f} (drift {drift:+.4f})")
        if best is None or ap > best_ap:
            best, best_ap = int(t), ap
        if drift >= drift_bar:
            return int(t), table
    log(f"[select_tail] no candidate clears drift {drift_bar}; "
        f"falling back to best tail {best}")
    return best, table


def parse_args(argv: list[str] | None):
    p = argparse.ArgumentParser(
        prog="python -m face_vijnana_yolov3_tpu_torch.scripts.select_serving_tail",
        description="Measure the int8 tail frontier on held-out AP50 and pin it.")
    p.add_argument("workdir", nargs="?", default=DEFAULT_WORKDIR)
    p.add_argument("ckpt_name", nargs="?", default="fd_ckpt_qat")
    p.add_argument("--tails", default=",".join(map(str, CANDIDATE_TAILS)),
                   help="candidate bf16 tails, fastest first")
    p.add_argument("--drift-bar", type=float, default=DRIFT_BAR)
    p.add_argument("--device", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> tuple[int, dict[int, float]]:
    """Select and pin; returns (tail, table)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    tails = tuple(int(t) for t in args.tails.split(","))
    tail, table = select_tail(args.workdir, args.ckpt_name, tails, args.drift_bar,
                              device=device)
    ckpt = ckpt_path(args.workdir, args.ckpt_name)
    meta = update_train_meta(ckpt, int8_tail=tail, int8_tail_table=table)
    print(f"[select_tail] pinned int8_tail={tail} into {ckpt}.trainmeta.json ({meta})")
    return tail, table


if __name__ == "__main__":
    main()
