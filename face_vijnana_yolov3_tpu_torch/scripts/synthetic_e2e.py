"""End-to-end face detection on synthetic data: train from random init,
evaluate, score.

Port of scripts/synthetic_e2e.py (the JAX repo's tooling): writes a seeded
synthetic set (`data/synthetic.make_dataset`: bright disks on textured
noise), trains the detector from random init through the real training
pipeline (`FaceDetectorPipeline.train`), copies the val split to
`<workdir>/valset`, runs evaluate mode (solution_fd.csv) and scores it with
the mAP harness (`evals/detection.map_sweep`): the train → detect → NMS →
CSV → AP loop as one system. An existing checkpoint resumes.

Usage: python -m face_vijnana_yolov3_tpu_torch.scripts.synthetic_e2e
       [workdir] [epochs] [n_train] [n_val] [precision] [--device DEV]

Defaults: `.bench_cache_torch/synth`, 25 epochs, 160 train and 40 val
images, float32. A short run may clear face_conf_th on no val image: that
prints AP 0 instead of failing. p_r_curve.h5 is written where h5py is
installed.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import os
import shutil

import numpy as np
import pandas as pd

from face_vijnana_yolov3_tpu_torch.api.config import FdConf
from face_vijnana_yolov3_tpu_torch.api.face_detection import (
    FaceDetectorPipeline,
    resolve_device,
)
from face_vijnana_yolov3_tpu_torch.core.checkpoints import checkpoint_exists
from face_vijnana_yolov3_tpu_torch.data.synthetic import make_dataset
from face_vijnana_yolov3_tpu_torch.evals.detection import map_sweep
from face_vijnana_yolov3_tpu_torch.scripts import DEFAULT_WORKDIR


def make_valset(workdir: str) -> str:
    """Copy the val JPEGs and validation.csv of a `make_dataset` set to
    `<workdir>/valset`, the test directory the AP tools read; returns it."""
    valdir = os.path.join(workdir, "valset")
    os.makedirs(valdir, exist_ok=True)
    for f in glob.glob(os.path.join(workdir, "val_*.jpg")):
        dst = os.path.join(valdir, os.path.basename(f))
        if not os.path.exists(dst):
            shutil.copy(f, dst)
    pd.read_csv(os.path.join(workdir, "validation.csv")).to_csv(
        os.path.join(valdir, "validation.csv"), index=False)
    return valdir


def parse_args(argv: list[str] | None):
    p = argparse.ArgumentParser(
        prog="python -m face_vijnana_yolov3_tpu_torch.scripts.synthetic_e2e",
        description="Train, evaluate and score the detector on synthetic data.")
    p.add_argument("workdir", nargs="?", default=os.path.join(DEFAULT_WORKDIR, "synth"))
    p.add_argument("epochs", nargs="?", type=int, default=25)
    p.add_argument("n_train", nargs="?", type=int, default=160)
    p.add_argument("n_val", nargs="?", type=int, default=40)
    p.add_argument("precision", nargs="?", default="float32")
    p.add_argument("--device", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> np.ndarray:
    """Run the loop; returns the APs at IoU 0.50:0.05:0.95 (zeros when
    nothing was scored)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    workdir = args.workdir
    print(f"dataset → {workdir} ({args.n_train} train / {args.n_val} val)")
    make_dataset(workdir, n_train=args.n_train, n_val=args.n_val)

    conf = FdConf(
        raw_data_path=workdir,
        test_path=workdir,
        output_file_path=os.path.join(workdir, "solution_fd.csv"),
        weights_path="missing.weights",  # train from random init
        model_path=os.path.join(workdir, "fd_ckpt.pt"),
    )
    conf.hps.lr = 1e-3
    conf.hps.epochs = args.epochs
    conf.hps.batch_size = 16
    conf.hps.face_conf_th = 0.5
    conf.checkpoint_every = 10       # kill-resume for long runs
    conf.dataset_cache = "samples"   # decode each JPEG once
    if checkpoint_exists(conf.model_path):
        print("resuming from", conf.model_path)
        conf.model_loading = True

    fd = FaceDetectorPipeline(conf, precision=args.precision, device=device)
    losses = fd.train()
    print(f"loss: first {losses[0]:.4f} → last {losses[-1]:.4f}")

    # train() dropped the folded and int8 programs of the old weights, so
    # evaluate serves the trained ones.
    conf.test_path = make_valset(workdir)
    fd.evaluate()
    has_h5py = importlib.util.find_spec("h5py") is not None
    try:
        _, _, maps = map_sweep(
            os.path.join(conf.test_path, "validation.csv"),
            conf.output_file_path,
            out_h5=os.path.join(workdir, "p_r_curve.h5") if has_h5py else None,
        )
    except ValueError as e:
        # A short run may clear face_conf_th on no val image (or on none
        # overlapping a face): a truthful AP of 0, not a pipeline failure.
        # Any other ValueError (malformed rows) propagates.
        if "to score" not in str(e):
            raise
        print(f"scoring: {e}")
        print("AP50 = 0.0000  mAP = 0.0000  (no detections above "
              f"face_conf_th={conf.hps.face_conf_th})")
        return np.zeros(10)
    print("AP50..AP95:", [round(float(m), 4) for m in maps])
    print(f"AP50 = {maps[0]:.4f}  mAP = {np.mean(maps):.4f}")
    return maps


if __name__ == "__main__":
    main()
