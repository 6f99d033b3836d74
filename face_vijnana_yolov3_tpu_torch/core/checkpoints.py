"""`.pt` checkpoints + the trainmeta sidecar; Keras h5 weights read too.

A `.pt` file is a `torch.save`d state dict, or, when it carries the
optimizer for a resumed run, {"model": state dict, "opt_state": {"count",
"mu", "nu"}} (the JAX package's Orbax tree holds params, BN state and Adam
state the same way). The sidecar `<path>.trainmeta.json` is the JAX
package's (face_vijnana_yolov3_tpu/core/checkpoints.py:41-67): training
metadata such as {"qat": true} or the measured `int8_tail` serving pin.
`.h5`/`.hd5` paths load the reference's Keras weights (core/keras_import).
Orbax directories are refused with a message naming scripts/orbax_to_pt.py,
which converts them (it needs JAX, so it lives outside the package).
"""

from __future__ import annotations

import json
import os

import torch

_CONVERT_HINT = (
    "only .pt checkpoints (and Keras .h5/.hd5 weights) load here; convert an "
    "Orbax checkpoint of the JAX package with scripts/orbax_to_pt.py"
)
KERAS_SUFFIXES = (".h5", ".hd5")


def _require_pt(path: str) -> None:
    if not path.endswith(".pt"):
        raise ValueError(f"{path}: {_CONVERT_HINT}")


def save_checkpoint(path: str, state_dict: dict, meta: dict | None = None,
                    opt_state: dict | None = None) -> None:
    """`torch.save` a state dict to `path` (which must end in .pt), with the
    optimizer state beside it when given; `meta`, when given, goes to the
    JSON sidecar `<path>.trainmeta.json`."""
    _require_pt(path)
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    if opt_state is None:
        torch.save(sd, path)
    else:
        opt = {"count": opt_state["count"].detach().cpu(),
               **{m: {k: v.detach().cpu() for k, v in opt_state[m].items()}
                  for m in ("mu", "nu")}}
        torch.save({"model": sd, "opt_state": opt}, path)
    if meta is not None:
        with open(os.path.abspath(path) + ".trainmeta.json", "w") as f:
            json.dump(meta, f)


def _load_pt(path: str) -> dict:
    _require_pt(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return obj if "model" in obj else {"model": obj}


def load_checkpoint(path: str) -> dict:
    """The state dict saved by `save_checkpoint` (or read from a Keras h5
    detector file), on the CPU."""
    if path.endswith(KERAS_SUFFIXES):
        from face_vijnana_yolov3_tpu_torch.core.keras_import import (
            detector_from_keras_h5,
        )

        return detector_from_keras_h5(path)
    return _load_pt(path)["model"]


def load_opt_state(path: str) -> dict | None:
    """The optimizer state saved beside a `.pt` checkpoint's weights
    ({"count", "mu", "nu"}), or None (none saved, or an h5 file, which
    holds weights only)."""
    if path.endswith(KERAS_SUFFIXES):
        return None
    return _load_pt(path).get("opt_state")


def checkpoint_exists(path: str) -> bool:
    """Whether `save_checkpoint` has written `path` (checkpoints.py:85 tests
    for the JAX package's Orbax directory; here it is the `.pt` file)."""
    return path.endswith(".pt") and os.path.isfile(path)


def update_train_meta(path: str, **kv) -> dict:
    """Merge keys into a checkpoint's trainmeta sidecar; returns the result."""
    meta = load_train_meta(path)
    meta.update(kv)
    with open(os.path.abspath(path) + ".trainmeta.json", "w") as f:
        json.dump(meta, f)
    return meta


def load_train_meta(path: str) -> dict:
    """Sidecar training metadata for a checkpoint ({} when absent)."""
    p = os.path.abspath(path) + ".trainmeta.json"
    if not os.path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)
