"""Train the release checkpoint: plain, QAT from scratch, or QAT finetune.

Port of scripts/train_qat_recipe.py (the JAX repo's tooling). Recipe v3 is
two runs of this tool on one workdir holding a seeded synthetic set
(`data/synthetic.make_dataset`, `training.csv` + JPEGs): 400 plain epochs
into `fd_ckpt_plain`, then 100 fake-quant epochs at lr 1e-4 into
`fd_ckpt_qat`, seeded `--init-from fd_ckpt_plain` (a copy of its `.pt`,
weights + BN + Adam state, and its trainmeta sidecar):

    python -m face_vijnana_yolov3_tpu_torch.scripts.train_qat_recipe W 400 --plain
    python -m face_vijnana_yolov3_tpu_torch.scripts.train_qat_recipe W 100 \\
        --init-from fd_ckpt_plain --lr 1e-4

Usage: [workdir] [target_epochs] [--plain] [--ckpt NAME] [--meta NAME]
[--init-from NAME] [--lr LR] [--device DEV]

Kill-safe: training runs in chunks of CHUNK epochs, each recorded in the
meta json (`epochs_done`, `sec_per_epoch`) after its checkpoint is saved;
inside a chunk the trainer saves every 20 epochs, and a killed run resumes
from the last save (only the meta json lags). The trainer's saves rewrite
the sidecar as {"qat": ...}, so a tail pinned before the recipe finishes
is lost, as in the JAX package: select the tail on the finished artifact.

Differences from the JAX script: checkpoints are `<workdir>/<NAME>.pt`,
the default workdir is `.bench_cache_torch`, there is no compile cache to
enable, and the meta also records "recipe_ver": RECIPE_VER, so a bench can
adopt a run made here.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

from face_vijnana_yolov3_tpu_torch.api.config import FdConf
from face_vijnana_yolov3_tpu_torch.api.face_detection import (
    FaceDetectorPipeline,
    resolve_device,
)
from face_vijnana_yolov3_tpu_torch.core.checkpoints import checkpoint_exists
from face_vijnana_yolov3_tpu_torch.scripts import DEFAULT_WORKDIR, ckpt_path

# Per-chunk fixed cost (pipeline re-init, BN finalize, the save) against
# the epochs it amortises over; kill-safety comes from the trainer's
# checkpoint_every=20 interval saves (scripts/train_qat_recipe.py:36-41).
CHUNK = 120
RECIPE_VER = 3


def parse_args(argv: list[str] | None):
    p = argparse.ArgumentParser(
        prog="python -m face_vijnana_yolov3_tpu_torch.scripts.train_qat_recipe",
        description="Train the release checkpoint in kill-safe chunks.")
    p.add_argument("workdir", nargs="?", default=DEFAULT_WORKDIR)
    p.add_argument("target", nargs="?", type=int, default=400,
                   help="epochs this checkpoint's meta json should reach")
    p.add_argument("--plain", action="store_true", help="no fake-quant")
    p.add_argument("--ckpt", help="checkpoint name (default fd_ckpt_plain "
                   "with --plain, else fd_ckpt_qat)")
    p.add_argument("--meta", help="meta json name (default meta_<ckpt suffix>.json)")
    p.add_argument("--init-from", help="seed a new checkpoint from this one")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--device", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> tuple[dict, list[float]]:
    """Run the recipe; returns (the meta json, the per-step losses of the
    chunks this call trained)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    ckpt_name = (args.ckpt or ("fd_ckpt_plain" if args.plain else "fd_ckpt_qat")
                 ).removesuffix(".pt")
    meta_name = args.meta or (
        f"meta_{ckpt_name.removeprefix('fd_ckpt_')}.json"
        if ckpt_name != "fd_ckpt_qat" else "meta_qat.json")
    workdir = args.workdir
    ckpt = ckpt_path(workdir, ckpt_name)
    meta_path = os.path.join(workdir, meta_name)
    meta = {"epochs_done": 0}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)

    if not os.path.exists(os.path.join(workdir, "training.csv")):
        raise SystemExit(f"no dataset under {workdir}: write one first "
                         "(data/synthetic.make_dataset)")

    if args.init_from and not checkpoint_exists(ckpt):
        # The finetune seed: the converged source's weights, BN and Adam
        # state, and its trainmeta sidecar; training resumes on top of it.
        src = ckpt_path(workdir, args.init_from)
        shutil.copy(src, ckpt)
        if os.path.exists(src + ".trainmeta.json"):
            shutil.copy(src + ".trainmeta.json", ckpt + ".trainmeta.json")
        print(f"[qat-recipe] seeded {ckpt} from {src}", flush=True)

    losses_all: list[float] = []
    while meta["epochs_done"] < args.target:
        n = min(CHUNK, args.target - meta["epochs_done"])
        conf = FdConf(
            raw_data_path=workdir,
            test_path=workdir,
            weights_path="missing.weights",
            model_path=ckpt,
        )
        conf.hps.lr = args.lr
        conf.hps.epochs = n
        conf.hps.batch_size = 16
        conf.train_qat = not args.plain
        conf.dataset_cache = "disk"
        conf.checkpoint_every = 20  # interval saves: a killed chunk resumes
        if checkpoint_exists(ckpt):
            conf.model_loading = True
        t0 = time.monotonic()
        fd = FaceDetectorPipeline(conf, device=device)
        losses = fd.train()
        dt = time.monotonic() - t0
        losses_all += losses
        meta["epochs_done"] += n
        meta["sec_per_epoch"] = round(dt / n, 2)
        meta["recipe_ver"] = RECIPE_VER
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        print(
            f"[qat-recipe] epoch {meta['epochs_done']}/{args.target} "
            f"({dt / n:.1f} s/epoch, loss {losses[0]:.6f} -> {losses[-1]:.6f})",
            flush=True,
        )

    print(f"[qat-recipe] DONE: {meta['epochs_done']} epochs at {ckpt}")
    return meta, losses_all


if __name__ == "__main__":
    main()
