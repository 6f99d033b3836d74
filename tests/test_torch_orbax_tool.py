"""scripts/orbax_to_pt.py: a JAX-package Orbax checkpoint (params, BN
state, Keras Adam state, trainmeta sidecar) becomes the port's `.pt`, bit
for bit (a small conv/BN/head tree keeps the Orbax write short; the
mapping is per tensor)."""

import sys
from pathlib import Path

import numpy as np
import torch

from face_vijnana_yolov3_tpu.core import checkpoints as jax_ckpt
from face_vijnana_yolov3_tpu.train.optimizer import keras_adam
from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
from face_vijnana_yolov3_tpu_torch.core.checkpoints import (
    load_checkpoint,
    load_opt_state,
    load_train_meta,
)
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import orbax_to_pt  # noqa: E402


def test_orbax_checkpoint_converts_to_pt(tmp_path):
    rng = np.random.default_rng(1)
    params = {"conv_0": {"kernel": rng.normal(size=(3, 3, 3, 8)).astype(np.float32)},
              "bnorm_0": {"gamma": rng.uniform(0.5, 1.5, 8).astype(np.float32),
                          "beta": rng.normal(size=8).astype(np.float32)},
              "head": {"kernel": rng.normal(size=(3, 3, 8, 6)).astype(np.float32),
                       "bias": rng.normal(size=6).astype(np.float32)}}
    state = {"bnorm_0": {"mean": rng.normal(size=8).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}}
    tx = keras_adam(1e-3)
    opt = tx.init(params)
    for _ in range(2):
        grads = {k: {f: rng.normal(size=v.shape).astype(np.float32) for f, v in e.items()}
                 for k, e in params.items()}
        _, opt = tx.update(grads, opt)
    src = str(tmp_path / "ckpt")
    jax_ckpt.save_checkpoint(src, {"params": params, "state": state, "opt_state": opt},
                             meta={"qat": True, "int8_tail": 4})
    out = str(tmp_path / "ckpt.pt")
    orbax_to_pt.convert(src, out)
    assert load_train_meta(out) == {"qat": True, "int8_tail": 4}
    sd, want = load_checkpoint(out), params_from_jax(params, state)
    assert set(sd) == set(want) and all(torch.equal(sd[k], want[k]) for k in want)
    got_opt = load_opt_state(out)
    assert int(got_opt["count"]) == 2
    for moment in ("mu", "nu"):
        want_m = params_from_jax(getattr(opt, moment), {})
        assert set(got_opt[moment]) == set(want_m)
        assert all(torch.equal(got_opt[moment][k], want_m[k]) for k in want_m)
