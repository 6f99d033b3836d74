"""Convert a JAX-package Orbax checkpoint to the PyTorch port's `.pt`.

    python scripts/orbax_to_pt.py ORBAX_DIR OUT.pt

Reads the checkpoint with face_vijnana_yolov3_tpu.core.checkpoints.
load_checkpoint ({"params", "state"[, "opt_state"]}), maps the trees to the
port's state-dict names and layouts with face_vijnana_yolov3_tpu_torch.
convert.params_from_jax (HWIO kernels become OIHW), carries the Keras Adam
state (count, and the moments mapped the same way) when the checkpoint has
one, and writes OUT.pt with the port's save_checkpoint, copying the
trainmeta sidecar (`qat`, `int8_tail`). It imports JAX and the JAX package,
so it lives here and not in the port, which imports neither.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(orbax_dir: str, out_pt: str) -> dict:
    """Write `out_pt` from `orbax_dir`; returns the state dict written."""
    import numpy as np
    import torch

    from face_vijnana_yolov3_tpu.core import checkpoints as jax_ckpt
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
    from face_vijnana_yolov3_tpu_torch.core import checkpoints

    tree = jax_ckpt.load_checkpoint(orbax_dir)
    sd = params_from_jax(tree["params"], tree["state"])
    opt = tree.get("opt_state")
    opt_state = None
    if opt is not None:
        if not isinstance(opt, dict):  # a KerasAdamState restored with a target
            opt = {"count": opt.count, "mu": opt.mu, "nu": opt.nu}
        opt_state = {"count": torch.as_tensor(np.asarray(opt["count"]), dtype=torch.int32),
                     "mu": params_from_jax(opt["mu"], {}),
                     "nu": params_from_jax(opt["nu"], {})}
    meta = jax_ckpt.load_train_meta(orbax_dir)
    checkpoints.save_checkpoint(out_pt, sd, meta=meta or None, opt_state=opt_state)
    return sd


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    convert(sys.argv[1], sys.argv[2])
    print(f"wrote {sys.argv[2]}")
