"""End-to-end face identification on synthetic identities.

Port of scripts/synthetic_fi_e2e.py (the JAX repo's tooling): writes a
UCCS-style tree of seeded synthetic identities (`data/synthetic.
make_fi_tree`), then drives the pipeline: `create_subject_db_uccs` → the
untrained registry (`make_facial_ids_db` → `register_facial_ids`) and its
held-out top-1 → triplet training (`FaceIdentifierPipeline.train`, bf16
mixed precision) → the trained registry, its held-out top-1 and the
VAL/FAR sweep (`evals.identification.cal_VAL_FAR`).

Usage: python -m face_vijnana_yolov3_tpu_torch.scripts.synthetic_fi_e2e
       [workdir] [epochs] [n_subjects] [mining] [--device DEV]

Defaults: `.bench_cache_torch/synth_fi`, 40 epochs, 12 subjects, random
mining, IMG = 416. The subject DB's files land in the workdir (the
pipeline writes them to the working directory, so main works there and
returns to the caller's afterwards). The triplet draw is seeded (seed 0).
`make_facial_ids_db` and `cal_VAL_FAR` read and write HDF5: where h5py is
not installed, `cal_VAL_FAR` reads the same embeddings from memory
(`data/facedb.facial_ids`).
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np
import torch

from face_vijnana_yolov3_tpu_torch.api.config import Conf
from face_vijnana_yolov3_tpu_torch.api.face_detection import resolve_device
from face_vijnana_yolov3_tpu_torch.api.face_identification import FaceIdentifierPipeline
from face_vijnana_yolov3_tpu_torch.data.facedb import create_subject_db_uccs, facial_ids
from face_vijnana_yolov3_tpu_torch.data.synthetic import holdout_crops, make_fi_tree
from face_vijnana_yolov3_tpu_torch.evals.identification import cal_VAL_FAR
from face_vijnana_yolov3_tpu_torch.ops.similarity import match_embeddings
from face_vijnana_yolov3_tpu_torch.scripts import DEFAULT_WORKDIR

IMG = 416
SIM_THS = np.arange(0.1, 1.01, 0.1)


def top1_acc(fi, crops, sids, registry):
    """Held-out top-1: each crop's nearest registry subject (one distance
    matrix, ops/similarity) against its true id; returns (accuracy, the
    (N,) match distances)."""
    subject_ids = list(registry.keys())
    reg = np.asarray([registry[s] for s in subject_ids], np.float32)
    best_idx, best_dist = match_embeddings(fi.embed_device(crops), torch.from_numpy(reg))
    pred = np.asarray([subject_ids[int(i)] for i in best_idx.cpu().numpy()])
    return float((pred == sids).mean()), best_dist.cpu().numpy()


def parse_args(argv: list[str] | None):
    p = argparse.ArgumentParser(
        prog="python -m face_vijnana_yolov3_tpu_torch.scripts.synthetic_fi_e2e",
        description="Train and score the identifier on synthetic identities.")
    p.add_argument("workdir", nargs="?",
                   default=os.path.join(DEFAULT_WORKDIR, "synth_fi"))
    p.add_argument("epochs", nargs="?", type=int, default=40)
    p.add_argument("n_subjects", nargs="?", type=int, default=12)
    p.add_argument("mining", nargs="?", default="random")
    p.add_argument("--device", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Run the loop; returns {"top1_untrained", "top1", "losses",
    "val_far": (sim_ths, vals, fars)}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)  # subject_image_db.csv etc. land in the cwd, as the reference's
    try:
        return _run(args, workdir, device)
    finally:
        os.chdir(cwd)


def _run(args, workdir: str, device) -> dict:
    has_h5py = importlib.util.find_spec("h5py") is not None
    print(f"dataset → {workdir} ({args.n_subjects} subjects)")
    # The JAX script's face sides (90-200 px at 416²), scaled with IMG.
    holdout = make_fi_tree(workdir, args.n_subjects, image_size=IMG,
                           face_sizes=(90 * IMG // 416, 200 * IMG // 416))
    crops, sids = holdout_crops(holdout, IMG)
    create_subject_db_uccs(workdir, image_size=IMG)

    conf = Conf()
    conf.fi_conf.raw_data_path = workdir
    conf.fi_conf.weights_path = "missing.weights"  # from-scratch trunk
    conf.fi_conf.model_path = os.path.join(workdir, "fi_ckpt.pt")
    conf.fi_conf.checkpoint_every = 10
    conf.fi_conf.hps.lr = 1e-4
    conf.fi_conf.hps.epochs = args.epochs
    conf.fi_conf.hps.batch_size = 24
    conf.fi_conf.negative_mining = args.mining
    conf.fi_conf.nn_arch.image_size = IMG
    conf.fd_conf.weights_path = "missing.weights"
    conf.fd_conf.nn_arch.image_size = IMG

    fi = FaceIdentifierPipeline(conf, precision="bfloat16", device=device, seed=0)

    # The untrained baseline (random trunk embeddings).
    if has_h5py:
        fi.make_facial_ids_db()
    acc0, _ = top1_acc(fi, crops, sids, fi.register_facial_ids())
    print(f"untrained top-1 holdout acc: {acc0:.3f} "
          f"(chance {1 / args.n_subjects:.3f})")

    losses = fi.train()
    print(f"triplet loss: first {losses[0]:.4f} → last {losses[-1]:.4f}")

    if has_h5py:
        fi.make_facial_ids_db()
    acc, dists = top1_acc(fi, crops, sids, fi.register_facial_ids())
    print(f"trained top-1 holdout acc: {acc:.3f}  "
          f"(match dists: med {np.median(dists):.3f} max {dists.max():.3f})")

    if has_h5py:
        val_far = cal_VAL_FAR(SIM_THS)
    else:
        print("h5py is not installed: VAL/FAR from the embeddings in memory "
              "(subject_facial_ids.h5 and val_far.h5 are not written)")
        ids = {ff: emb for _, ff, emb in facial_ids(fi.embed, workdir)}
        val_far = cal_VAL_FAR(SIM_THS, out_h5=None, ids_h5=ids)
    for th, v, fr in zip(*val_far):
        print(f"  sim_th {th:.1f}: VAL {v:.3f}  FAR {fr:.3f}")
    return {"top1_untrained": acc0, "top1": acc, "losses": losses, "val_far": val_far}


if __name__ == "__main__":
    main()
