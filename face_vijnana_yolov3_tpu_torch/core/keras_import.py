"""The reference's Keras HDF5 weights: import and export, through h5py alone.

Port of face_vijnana_yolov3_tpu/core/keras_import.py:21-205 for the trunk
and the detector (`collect_keras_weights`, `trunk_from_keras`,
`detector_from_keras_h5`, `_write_keras_h5`, `save_trunk_keras_h5`,
`save_detector_keras_h5`). The files hold layer-named tensors
(`conv_i/kernel:0` HWIO, `bnorm_i/{gamma,beta,moving_mean,moving_variance}:0`,
`output/{kernel,bias}:0`) under `model_weights`, possibly nested; Keras 2.2.4
names datasets `kernel:0`, Keras 3 drops the `:0`, and both import. Reading
gives the port's state dicts (OIHW, `convert.params_from_jax` naming);
writing takes them and writes HWIO in the Keras 2.2.4 layout
`model_weights/<layer>/<layer>/<weight>:0`. The identifier and full-YOLOv3
variants come with their slices (ROADMAP.md queue 1 items 9 and 10).
"""

from __future__ import annotations

import numpy as np
import torch

from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
from face_vijnana_yolov3_tpu_torch.models.darknet import conv_layout, trunk_graph


def collect_keras_weights(h5_path: str) -> dict[str, np.ndarray]:
    """{'conv_0/kernel:0': array, ...} from any Keras-2.x- or 3-style h5:
    every dataset under `model_weights` (or the root) keyed by its last two
    path parts, a missing ':0' added."""
    import h5py

    out: dict[str, np.ndarray] = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            parts = name.split("/")
            leaf = parts[-1] if ":" in parts[-1] else parts[-1] + ":0"
            out[parts[-2] + "/" + leaf] = np.asarray(obj)

    with h5py.File(h5_path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        root.visititems(visit)
    return out


def _trees_from_keras(weights: dict, layout) -> tuple[dict, dict]:
    """(params, state) numpy trees in the JAX layout for the layout's convs."""
    params: dict = {}
    state: dict = {}
    for idx, _i, _o, _k, _s, bn in layout:
        entry = {"kernel": weights[f"conv_{idx}/kernel:0"]}
        if not bn:
            entry["bias"] = weights[f"conv_{idx}/bias:0"]
        params[f"conv_{idx}"] = entry
        if bn:
            name = f"bnorm_{idx}"
            params[name] = {"gamma": weights[f"{name}/gamma:0"],
                            "beta": weights[f"{name}/beta:0"]}
            state[name] = {"mean": weights[f"{name}/moving_mean:0"],
                           "var": weights[f"{name}/moving_variance:0"]}
    return params, state


def trunk_from_keras(weights: dict) -> dict[str, torch.Tensor]:
    """conv_0..73 and their BNs → a trunk state dict (f32, OIHW)."""
    return params_from_jax(*_trees_from_keras(weights, conv_layout(trunk_graph())))


def detector_from_keras_h5(h5_path: str) -> dict[str, torch.Tensor]:
    """face_detector.h5 → the detector's state dict, the 6-channel `output`
    layer as `head`."""
    weights = collect_keras_weights(h5_path)
    params, state = _trees_from_keras(weights, conv_layout(trunk_graph()))
    params["head"] = {"kernel": weights["output/kernel:0"],
                      "bias": weights["output/bias:0"]}
    return params_from_jax(params, state)


def _write_keras_h5(h5_path: str, layout, state_dict: dict,
                    extra_layers: tuple = ()) -> None:
    """Write a Keras-2.2.4-layout weights h5 from a state dict: the
    layout's conv/bnorm layers, then each (h5 layer, state-dict prefix) of
    `extra_layers` as kernel + bias. Weights only, as in the JAX package."""
    import h5py

    def host(name):
        return state_dict[name].detach().float().cpu().numpy()

    def hwio(name):
        return np.ascontiguousarray(host(name).transpose(2, 3, 1, 0))

    with h5py.File(h5_path, "w") as f:
        root = f.create_group("model_weights")

        def put(layer, wname, arr):
            root.require_group(layer).create_dataset(
                f"{layer}/{wname}:0", data=np.asarray(arr, np.float32))

        for idx, _i, _o, _k, _s, bn in layout:
            put(f"conv_{idx}", "kernel", hwio(f"conv_{idx}.weight"))
            if not bn:
                put(f"conv_{idx}", "bias", host(f"conv_{idx}.bias"))
            else:
                name = f"bnorm_{idx}"
                put(name, "gamma", host(f"{name}.gamma"))
                put(name, "beta", host(f"{name}.beta"))
                put(name, "moving_mean", host(f"{name}.mean"))
                put(name, "moving_variance", host(f"{name}.var"))
        for layer, prefix in extra_layers:
            put(layer, "kernel", hwio(f"{prefix}.weight"))
            put(layer, "bias", host(f"{prefix}.bias"))


def save_trunk_keras_h5(state_dict: dict, h5_path: str) -> None:
    """The trunk as the reference's `yolov3_base.h5` cache (written after a
    darknet .weights build; read back by `trunk_from_keras`). Entries
    outside the trunk (the head) are not written."""
    _write_keras_h5(h5_path, conv_layout(trunk_graph()), state_dict)


def save_detector_keras_h5(state_dict: dict, h5_path: str) -> None:
    """The detector as the reference's `face_detector.h5` (the trunk plus
    the `output` head); `detector_from_keras_h5` reads it back."""
    _write_keras_h5(h5_path, conv_layout(trunk_graph()), state_dict,
                    extra_layers=(("output", "head"),))
