"""The port's copy of the JSON config (api/config.py) equals the JAX package's.

The port may import nothing of the JAX package, so it carries its own copy
of face_vijnana_yolov3_tpu/api/config.py. These tests hold the copy to the
original: the dataclass defaults, and `load_conf` + `apply_overrides` of the
same JSON, compared through `dataclasses.asdict`, so the two cannot drift.
"""

import dataclasses
import json
from pathlib import Path

import pytest

from face_vijnana_yolov3_tpu.api import config as jax_config
from face_vijnana_yolov3_tpu_torch.api import config as port_config
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["FdHps", "FdNNArch", "FdConf", "FiHps",
                                  "FiNNArch", "FiConf", "Conf"])
def test_defaults_match(name):
    assert (dataclasses.asdict(getattr(port_config, name)())
            == dataclasses.asdict(getattr(jax_config, name)()))
    assert ([f.name for f in dataclasses.fields(getattr(port_config, name))]
            == [f.name for f in dataclasses.fields(getattr(jax_config, name))])


_DATA = {
    "fd_conf": {"mode": "test", "test_path": "/data/x", "int8_bf16_tail": 3,
                "int8_calib_percentile": 99.9, "int8_pallas_blocks": True,
                "hps": {"batch_size": 8, "face_conf_th": 0.05},
                "nn_arch": {"image_size": 64}},
    "fi_conf": {"mode": "evaluate", "model_axis": 2, "hps": {"sim_th": 0.3}},
}
_OVERRIDES = ["fd_conf.mode=evaluate", "fd_conf.hps.lr=1e-3",
              "fd_conf.int8_bf16_ops=[14, 17]", "fi_conf.nn_arch.dense1_dim=32",
              "fd_conf.model_path=some/path"]


@pytest.mark.parametrize("source", ["dict", "file", "repo_json"])
def test_load_conf_and_overrides_match(source, tmp_path):
    if source == "dict":
        kw = {"data": _DATA}
    elif source == "file":
        path = tmp_path / "conf.json"
        path.write_text(json.dumps(_DATA))
        kw = {"path": str(path)}
    else:
        kw = {"path": str(REPO / "face_vijnana_yolov3.json")}
    want = jax_config.apply_overrides(jax_config.load_conf(**kw), _OVERRIDES)
    got = port_config.apply_overrides(port_config.load_conf(**kw), _OVERRIDES)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert port_config.conf_to_dict(got) == jax_config.conf_to_dict(want)


def test_unknown_override_raises_like_jax():
    for mod in (jax_config, port_config):
        with pytest.raises(KeyError, match="unknown config key"):
            mod.apply_overrides(mod.Conf(), ["fd_conf.no_such_key=1"])
