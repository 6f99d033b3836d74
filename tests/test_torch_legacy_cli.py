"""The docker variant's `--mode` CLI of the port vs the JAX package's.

`legacy_args_to_conf` must build the JAX package's FdConf from the same
flags (the `face_detector.hd5` artifact, batch_size = n_files //
step_per_epoch, model_loading forced on outside train, the face-region
ratio on), and `--mode test` must write the CSV that the `--conf` CLI
writes for that conf, and the JAX package's legacy CLI's rows. Both
packages read the same seeded weights from `face_detector.hd5` in the
working directory (64², the synthetic set of tests/test_torch_face_detection.py).
Scores within 5e-5 of the JAX package's (that file's rule: two sigmoids of
heads that differ by conv summation order; measured 6 ULP there), boxes
and rows exact; the port's two CLIs write byte-identical files.
"""

import argparse
import dataclasses
import json

import numpy as np
import pandas as pd
import pytest
import torch

from face_vijnana_yolov3_tpu.api import face_detection as jax_fd
from face_vijnana_yolov3_tpu_torch.api import face_detection as port_fd
from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
from face_vijnana_yolov3_tpu_torch.core.keras_import import save_detector_keras_h5
from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel

from test_torch_face_detection import SCORE_ATOL, _make_synthetic_testdir

torch.set_num_threads(2)
port_fd.DEBUG = False

FLAGS = {"image_size": "64", "num_filters": "6", "lr": "0.001", "beta_1": "0.99",
         "beta_2": "0.99", "decay": "0.0", "step_per_epoch": "2", "epochs": "3",
         "face_conf_th": "0.05", "nms_iou_th": "0.5", "num_cands": "60",
         "model_loading": "0"}


def _argv(mode, raw, out, **over):
    flags = {**FLAGS, **over, "mode": mode, "raw_data_path": str(raw),
             "output_file_path": str(out)}
    return [a for k, v in flags.items() for a in (f"--{k}", v)]


def _namespace(argv):
    it = iter(argv)
    return argparse.Namespace(**{k[2:]: v for k, v in zip(it, it)})


@pytest.mark.parametrize("mode,model_loading", [("train", "0"), ("train", "1"),
                                                ("evaluate", "0"), ("test", "0")])
def test_legacy_args_to_conf_matches_jax(tmp_path, mode, model_loading):
    raw = _make_synthetic_testdir(tmp_path)
    pd.read_csv(raw / "validation.csv").to_csv(raw / "training.csv", index=False)
    args = _namespace(_argv(mode, raw, tmp_path / "out.csv", model_loading=model_loading))
    got = port_fd.legacy_args_to_conf(args)
    want = jax_fd.legacy_args_to_conf(args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.model_path == "face_detector.hd5" and got.apply_face_region_ratio
    assert got.model_loading == (mode != "train" or model_loading == "1")
    if mode == "train":
        assert got.hps.batch_size == 3 // 2  # n_files // step_per_epoch


def _rows(path):
    return [line.split(",") for line in open(path).read().splitlines()]


def test_mode_test_writes_the_conf_clis_csv(tmp_path, monkeypatch):
    (tmp_path / "set").mkdir()
    raw = _make_synthetic_testdir(tmp_path / "set")
    monkeypatch.chdir(tmp_path)
    params, state = FaceDetectorModel(image_size=64, device="cpu").init_params(5)
    save_detector_keras_h5(params_from_jax(params, state), "face_detector.hd5")

    port_fd.main(_argv("test", raw, tmp_path / "legacy.csv"), device="cpu")
    conf = {"fd_conf": {"mode": "test", "test_path": str(raw),
                        "output_file_path": str(tmp_path / "conf.csv"),
                        "model_loading": True, "model_path": "face_detector.hd5",
                        "apply_face_region_ratio": True,
                        "hps": {"face_conf_th": 0.05, "nms_iou_th": 0.5, "num_cands": 60},
                        "nn_arch": {"image_size": 64, "bb_info_c_size": 6}}}
    (tmp_path / "conf.json").write_text(json.dumps(conf))
    port_fd.main([f"--conf={tmp_path / 'conf.json'}"], device="cpu")
    legacy = (tmp_path / "legacy.csv").read_text()
    assert legacy == (tmp_path / "conf.csv").read_text() and legacy

    jax_fd.main(_argv("test", raw, tmp_path / "jax.csv"))
    got, want = _rows(tmp_path / "legacy.csv"), _rows(tmp_path / "jax.csv")
    assert [r[:5] for r in got] == [r[:5] for r in want]
    assert np.abs(np.array([float(r[5]) for r in got])
                  - np.array([float(r[5]) for r in want])).max() <= SCORE_ATOL
