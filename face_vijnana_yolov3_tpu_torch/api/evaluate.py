"""Offline metric CLI — reference `evaluate.py` parity
(reference src/space/evaluate.py:331-402).

A copy of face_vijnana_yolov3_tpu/api/evaluate.py with its detection modes
(tests/test_torch_evals.py holds them to the original); the identification
modes wait for the identification slice (ROADMAP.md queue 1 item 9) and
raise until then.

Modes:
  cal_map_fd           detection P-R/AP sweep → p_r_curve.h5
                       (with --plot PNG also renders the P-R figure)
  plot_p_r_curve       render an existing p_r_curve.h5 (-s) → P-R figure
                       (the reference's pics/p_v_curve.png, README.md:177-180
                       — the one published artifact with no in-repo producer)
  cal_face_pairs_dists embedding pair distances → face_pairs_dists.h5
  cal_VAL_FAR          VAL/FAR sweep → val_far.h5
  cal_acc_fi           identification accuracy sweep → fi_acc.h5

Usage: python -m face_vijnana_yolov3_tpu_torch.api.evaluate -m MODE -g GT -s SOL
"""

from __future__ import annotations

import argparse

MODE_CAL_MAP_FD = "cal_map_fd"
MODE_PLOT_PR = "plot_p_r_curve"
MODE_CAL_FACE_PAIRS_DISTS = "cal_face_pairs_dists"
MODE_CAL_VAL_FAR = "cal_VAL_FAR"
MODE_CAL_ACC_FI = "cal_acc_fi"


def main(args=None):
    parser = argparse.ArgumentParser(
        description="Evaluate face recognition's performance metric."
    )
    parser.add_argument("-m", "--mode")
    parser.add_argument("-g", "--gt_path")
    parser.add_argument("-s", "--sol_path")
    parser.add_argument("--plot", default=None, metavar="PNG",
                        help="also render the P-R figure (cal_map_fd), or "
                             "the output path for plot_p_r_curve "
                             "(default p_v_curve.png)")
    ns = parser.parse_args(args)

    if ns.mode == MODE_CAL_MAP_FD:
        from face_vijnana_yolov3_tpu_torch.evals.detection import (
            map_sweep,
            plot_pr_curves,
        )

        map_sweep(ns.gt_path, ns.sol_path)
        if ns.plot:
            plot_pr_curves("p_r_curve.h5", ns.plot)
    elif ns.mode == MODE_PLOT_PR:
        from face_vijnana_yolov3_tpu_torch.evals.detection import plot_pr_curves

        plot_pr_curves(ns.sol_path or "p_r_curve.h5",
                       ns.plot or "p_v_curve.png")
    elif ns.mode in (MODE_CAL_FACE_PAIRS_DISTS, MODE_CAL_VAL_FAR, MODE_CAL_ACC_FI):
        raise NotImplementedError(
            f"mode {ns.mode!r}: identification metrics are ROADMAP.md queue 1 "
            "item 9 (not ported yet)")
    else:
        raise SystemExit(f"unknown mode: {ns.mode}")


if __name__ == "__main__":
    main()
