"""Run recipe v3, cut short, twice from the same seeds and compare the two
runs' checkpoints tensor by tensor: is training on the card reproducible?

    python -m face_vijnana_yolov3_tpu_torch.scripts.recipe_repro W [plain] [qat] \\
        [--n-train 640] [--n-val 16] [--seed 0] [--device cuda]

Writes one seeded synthetic set at 416² (`data/synthetic.make_dataset`,
the JAX bench's 640-image draw by default) under W/data and copies it to
W/run_a and W/run_b. In each it runs `train_qat_recipe` as recipe v3 does,
each call a process of its own: `plain` epochs with --plain (default 10),
then `qat` fake-quant epochs --init-from fd_ckpt_plain at lr 1e-4 (default
5). Then, for fd_ckpt_plain and fd_ckpt_qat, it counts the tensors of the
two runs that differ (the model's and the Adam state's) and the steps of
their loss histories that differ, prints one line for each and the counts
as one JSON line last. Run as a file with another checkout first on
PYTHONPATH, it runs that checkout's recipe.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import torch

import face_vijnana_yolov3_tpu_torch
from face_vijnana_yolov3_tpu_torch.core.checkpoints import load_checkpoint, load_opt_state
from face_vijnana_yolov3_tpu_torch.data.synthetic import make_dataset


def _tensors(path: str) -> dict:
    """The model's tensors and the Adam state's, by name."""
    out = dict(load_checkpoint(path))
    opt = load_opt_state(path)
    out["opt.count"] = torch.as_tensor(opt["count"])
    for part in ("mu", "nu"):
        out.update({f"opt.{part}.{k}": v for k, v in opt[part].items()})
    return out


def _history(path: str) -> list:
    with open(path + "_history.jsonl") as f:
        return [json.loads(line)["loss"] for line in f]


def compare(a: str, b: str) -> dict:
    """Tensors and loss steps of two checkpoints that differ."""
    ta, tb = _tensors(a), _tensors(b)
    if set(ta) != set(tb):
        raise ValueError(f"{a} and {b} hold different tensors")
    ha, hb = _history(a), _history(b)
    return {"tensors": len(ta), "tensors_differ": sum(not torch.equal(v, tb[k])
                                                      for k, v in ta.items()),
            "max_abs_diff": max(float((v.double() - tb[k].double()).abs().max())
                                for k, v in ta.items() if v.numel()),
            "steps": len(ha), "losses_differ": sum(x != y for x, y in zip(ha, hb))}


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m face_vijnana_yolov3_tpu_torch.scripts.recipe_repro",
        description="Train recipe v3, cut short, twice and compare the checkpoints.")
    p.add_argument("workdir")
    p.add_argument("plain", nargs="?", type=int, default=10)
    p.add_argument("qat", nargs="?", type=int, default=5)
    p.add_argument("--n-train", type=int, default=640)
    p.add_argument("--n-val", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(
        face_vijnana_yolov3_tpu_torch.__file__)))
    data = os.path.join(args.workdir, "data")
    make_dataset(data, n_train=args.n_train, n_val=args.n_val, image_size=416,
                 seed=args.seed)
    recipe = [sys.executable, "-m", "face_vijnana_yolov3_tpu_torch.scripts.train_qat_recipe"]
    runs = []
    for run in ("run_a", "run_b"):
        w = os.path.join(args.workdir, run)
        shutil.copytree(data, w)
        for extra in ([str(args.plain), "--plain"],
                      [str(args.qat), "--init-from", "fd_ckpt_plain", "--lr", "1e-4"]):
            # cwd: the checkout whose package this script imported (-m puts
            # the working directory first on the path).
            subprocess.run([*recipe, w, *extra, "--device", args.device], check=True,
                           cwd=root)
        runs.append(w)
    result = {}
    for name in ("fd_ckpt_plain", "fd_ckpt_qat"):
        result[name] = compare(*(os.path.join(w, f"{name}.pt") for w in runs))
        r = result[name]
        print(f"[recipe-repro] {name} ({args.plain} plain epochs"
              f"{'' if name.endswith('plain') else f' + {args.qat} fake-quant'}, "
              f"{args.n_train} images, seed {args.seed}) from {root}: "
              f"{r['tensors_differ']} of {r['tensors']} tensors differ (max |diff| "
              f"{r['max_abs_diff']:.3g}), {r['losses_differ']} of {r['steps']} losses")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
