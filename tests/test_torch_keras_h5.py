"""Keras h5 weights in the port (core/keras_import.py) vs the JAX package's.

Both directions, bit-equal: a file the JAX package writes loads in the port
to the same tensors (HWIO in the file, OIHW in the port), and a file the
port writes loads in the JAX package to the same trees. Both namings: Keras
2.2.4 (`kernel:0`, the JAX writer's) and Keras 3 (no `:0`, nested one group
deeper). The pipeline reads an h5 `model_path` and the `yolov3_base.h5`
trunk cache, and `train` with an h5 model_path trains against a sibling
`.pt` and exports the h5.
"""

import h5py
import jax
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.core import keras_import as jax_keras
from face_vijnana_yolov3_tpu.models.detector import FaceDetectorModel as JaxModel
from face_vijnana_yolov3_tpu_torch.api import face_detection as port_fd
from face_vijnana_yolov3_tpu_torch.api.config import FdConf
from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
from face_vijnana_yolov3_tpu_torch.core import keras_import
from face_vijnana_yolov3_tpu_torch.core.checkpoints import load_checkpoint
from face_vijnana_yolov3_tpu_torch.data import synthetic
from face_vijnana_yolov3_tpu_torch.models import darknet
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def trees():
    jm = JaxModel(image_size=64)
    params, state = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    params = {k: dict(v) for k, v in params.items()}
    state = {k: dict(v) for k, v in state.items()}
    darknet.perturb_batchnorm(params, state, jm.ops, 5)
    return params, state


def _assert_sd_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_jax_file_loads_in_the_port(trees, tmp_path):
    params, state = trees
    path = str(tmp_path / "face_detector.h5")
    jax_keras.save_detector_keras_h5(params, state, path)
    _assert_sd_equal(keras_import.detector_from_keras_h5(path), params_from_jax(params, state))
    _assert_sd_equal(load_checkpoint(path), params_from_jax(params, state))


def test_port_file_loads_in_jax(trees, tmp_path):
    params, state = trees
    path = str(tmp_path / "face_detector.h5")
    keras_import.save_detector_keras_h5(params_from_jax(params, state), path)
    got_p, got_s = jax_keras.detector_from_keras_h5(path)
    for tree, want in ((got_p, params), (got_s, state)):
        assert set(tree) == set(want)
        for name in want:
            for field in want[name]:
                np.testing.assert_array_equal(np.asarray(tree[name][field]), want[name][field])
    # The trunk cache: the trunk only, no head.
    trunk = str(tmp_path / "yolov3_base.h5")
    keras_import.save_trunk_keras_h5(params_from_jax(params, state), trunk)
    weights = jax_keras.collect_keras_weights(trunk)
    assert not any(k.startswith("output/") for k in weights)
    jp, js = jax_keras.trunk_from_keras(weights)
    _assert_sd_equal(params_from_jax(jax.device_get(jp), jax.device_get(js)),
                     keras_import.trunk_from_keras(keras_import.collect_keras_weights(trunk)))


def test_keras3_naming_loads_in_both(trees, tmp_path):
    """Keras 3 h5 files drop the ':0' and may nest the layers deeper."""
    params, state = trees
    src = str(tmp_path / "k2.h5")
    jax_keras.save_detector_keras_h5(params, state, src)
    dst = str(tmp_path / "k3.h5")
    with h5py.File(src, "r") as fin, h5py.File(dst, "w") as fout:
        def copy(name, obj):
            if isinstance(obj, h5py.Dataset):
                layer, leaf = name.split("/")[-2], name.split("/")[-1]
                fout.create_dataset(f"model_weights/base/{layer}/vars/{layer}/"
                                    f"{leaf.split(':')[0]}", data=obj[()])
        fin.visititems(copy)
    want = params_from_jax(params, state)
    _assert_sd_equal(keras_import.detector_from_keras_h5(dst), want)
    jp, js = jax_keras.detector_from_keras_h5(dst)
    _assert_sd_equal(params_from_jax(jax.device_get(jp), jax.device_get(js)), want)


def _conf(tmp_path, **kw):
    conf = FdConf(mode="test", test_path=str(tmp_path), weights_path="none.weights",
                  output_file_path=str(tmp_path / "x.csv"), **kw)
    conf.nn_arch.image_size = 64
    return conf


def test_pipeline_loads_h5_and_the_trunk_cache(trees, tmp_path, monkeypatch):
    params, state = trees
    path = str(tmp_path / "face_detector.h5")
    jax_keras.save_detector_keras_h5(params, state, path)
    fd = port_fd.FaceDetectorPipeline(_conf(tmp_path, model_loading=True, model_path=path),
                                      device="cpu")
    _assert_sd_equal(fd.model.state_dict(), params_from_jax(params, state))
    assert fd.opt_state is None
    monkeypatch.chdir(tmp_path)
    jax_keras.save_trunk_keras_h5(params, state, "yolov3_base.h5")
    fd = port_fd.FaceDetectorPipeline(_conf(tmp_path, yolov3_base_model_load=True),
                                      device="cpu")
    sd = fd.model.state_dict()
    want = params_from_jax(params, state)
    for k in want:
        if not k.startswith("head."):
            assert torch.equal(sd[k], want[k]), k
    fresh = port_fd.FaceDetectorPipeline(_conf(tmp_path), device="cpu").model.state_dict()
    assert torch.equal(sd["head.weight"], fresh["head.weight"])  # a fresh head


def test_train_with_an_h5_model_path_exports_the_h5(tmp_path):
    root = synthetic.make_dataset(str(tmp_path / "data"), n_train=2, n_val=1,
                                  image_size=128, seed=2)
    path = str(tmp_path / "face_detector.h5")
    conf = _conf(tmp_path, raw_data_path=root, model_path=path)
    conf.hps.epochs, conf.hps.batch_size = 1, 2
    fd = port_fd.FaceDetectorPipeline(conf, device="cpu")
    losses = fd.train()
    assert len(losses) == 1 and np.isfinite(losses[0])
    _assert_sd_equal(keras_import.detector_from_keras_h5(path), fd.model.state_dict())
    _assert_sd_equal(load_checkpoint(path + ".pt"), fd.model.state_dict())
    assert (tmp_path / "face_detector.h5.pt_history.jsonl").exists()
