"""The port's copy of the native JPEG loader (data/native_loader.py) vs the
JAX package's, and its place in the pipeline.

Staged buffers are bit-equal to the JAX loader's (the same C++ source and
system libjpeg), full-size and DCT-scaled; `solution_fd.csv` from the native
decoder equals the PIL path's at f32 (both feed the same device letterbox
the same uint8 pixels). The library builds into build/native_loader/, not
native/. Tests that need the library skip, inside the test, where g++ or
libjpeg is missing.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from face_vijnana_yolov3_tpu.data import native_loader as jax_nl
from face_vijnana_yolov3_tpu_torch.api import face_detection as port_fd
from face_vijnana_yolov3_tpu_torch.api.config import FdConf
from face_vijnana_yolov3_tpu_torch.data import native_loader as nl
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)

SPECS = [(120, 160), (90, 200), (333, 251), (64, 64)]


def _need_native():
    if not nl.native_available():
        pytest.skip("g++ or libjpeg unavailable: the native loader cannot build")


def _make_jpegs(directory, specs=SPECS):
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate(specs):
        p = str(directory / f"img_{i}.jpg")
        base = rng.uniform(0, 255, (h, w, 3))
        base[h // 4: h // 2, w // 4: w // 2] = (220, 190, 160)  # a face-like blob
        Image.fromarray(base.astype(np.uint8)).save(p, quality=90)
        paths.append(p)
    return paths


def test_builds_outside_the_source_tree():
    _need_native()
    assert os.path.exists(nl.LIBRARY)
    assert os.sep + os.path.join("build", "native_loader") + os.sep in nl.LIBRARY


def test_staged_buffers_equal_the_jax_loader(tmp_path):
    _need_native()
    paths = _make_jpegs(tmp_path)
    got, got_dims = nl.decode_batch_staged(paths)
    want, want_dims = jax_nl.decode_batch_staged(paths)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_dims, want_dims)
    assert nl.jpeg_size(paths[2]) == jax_nl.jpeg_size(paths[2]) == (333, 251)
    for target in (64, 416):
        got_s = nl.decode_batch_staged_scaled(paths, target)
        want_s = jax_nl.decode_batch_staged_scaled(paths, target)
        for g, w in zip(got_s, want_s):
            np.testing.assert_array_equal(g, w)
        assert [nl.pick_scale_num(h, w, target) for h, w in SPECS] == \
            [jax_nl.pick_scale_num(h, w, target) for h, w in SPECS]


def _run_test_mode(tmp_path, name, monkeypatch, native: bool, scaled: bool = False):
    monkeypatch.setenv("FVY_DEVICE_LETTERBOX", "1")
    monkeypatch.setenv("FVY_JPEG_SCALED_DECODE", "1" if scaled else "0")
    if not native:
        monkeypatch.setattr(nl, "native_available", lambda: False)
    conf = FdConf(mode="test", test_path=str(tmp_path), weights_path="none.weights",
                  output_file_path=str(tmp_path / name))
    conf.nn_arch.image_size = 64
    conf.hps.face_conf_th = 0.05
    conf.hps.batch_size = 3
    fd = port_fd.FaceDetectorPipeline(conf, device="cpu")
    fd.test()
    monkeypatch.undo()
    return fd, (tmp_path / name).read_text()


def test_solution_csv_native_equals_pil(tmp_path, monkeypatch):
    _need_native()
    _make_jpegs(tmp_path)
    fd_n, native = _run_test_mode(tmp_path, "native.csv", monkeypatch, native=True)
    fd_p, pil = _run_test_mode(tmp_path, "pil.csv", monkeypatch, native=False)
    assert fd_n.jpeg_decoder == "native" and fd_p.jpeg_decoder == "PIL"
    assert native == pil and native.count("\n") >= len(SPECS)


def test_scaled_decode_keeps_the_true_geometry(tmp_path, monkeypatch):
    """DCT-scaled decode (not bit-exact with a full decode, by design): the
    boxes come back in original coordinates, within each image."""
    _need_native()
    _make_jpegs(tmp_path, [(600, 800), (480, 360)])
    fd, text = _run_test_mode(tmp_path, "scaled.csv", monkeypatch, native=True, scaled=True)
    assert fd.jpeg_decoder == "native"
    rows = [line.split(",") for line in text.strip().splitlines()]
    assert rows
    sizes = {"img_0.jpg": (600, 800), "img_1.jpg": (480, 360)}
    for name, x, y, w, h, _score in rows:
        hh, ww = sizes[name]
        assert -1 <= float(x) <= ww and -1 <= float(y) <= hh
        assert float(x) + float(w) <= ww + 1 and float(y) + float(h) <= hh + 1
