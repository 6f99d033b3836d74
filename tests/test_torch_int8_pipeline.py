"""The whole int8 serving slice: the port's FaceDetectorPipeline(precision=
"int8") vs the JAX package's, on the CPU.

Both pipelines hold the same weights (seeded random kernels with seeded BN
statistics, models/darknet.perturb_batchnorm) and serve the same int8
program: the JAX pipeline calibrates on the letterboxed set, and the port
takes its qparams through `convert.qparams_from_jax`. Then both run test()
on four seeded 240x320 JPEGs at image_size 64, batch 2; the port with the
fused residual blocks on (the JAX package runs its stock convs: its Pallas
kernel has no CPU mode outside its tests' interpret flag).

Tolerances: the int8 trunk is bit-exact. The head conv is bf16 on both
sides, and bf16 rounds the sums of two conv implementations differently:
2e-2 of max |head| (test_torch_folded.py's bf16 bound). `solution_fd.csv`
inherits that: the same files and row counts, each box edge within one
letterbox pixel (5 px of the 240x320 originals: decode floors, so a head one
bf16 step apart can cross a pixel), scores within 1e-2 (two sigmoids of
slope <= 1/4 over the head tolerance at the logits' scale).
"""

import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from face_vijnana_yolov3_tpu.api.config import FdConf as JaxFdConf
from face_vijnana_yolov3_tpu.api.face_detection import (
    FaceDetectorPipeline as JaxPipeline,
)
from face_vijnana_yolov3_tpu.models import quant as jax_quant
from face_vijnana_yolov3_tpu_torch.api import face_detection as port_fd
from face_vijnana_yolov3_tpu_torch.api.config import FdConf
from face_vijnana_yolov3_tpu_torch.convert import params_from_jax, qparams_from_jax
from face_vijnana_yolov3_tpu_torch.core.checkpoints import (
    save_checkpoint,
    update_train_meta,
)
from face_vijnana_yolov3_tpu_torch.models import darknet, quant
from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
from face_vijnana_yolov3_tpu_torch.ops.block_int8 import block_int8
from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import conv_int8
from face_vijnana_yolov3_tpu_torch.ops.letterbox import (
    letterbox_geometry,
    letterbox_host,
)
from face_vijnana_yolov3_tpu_torch.utils.io import imread, imsave
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)

HEAD_TOL = 2e-2
EDGE_ATOL = 5.0
SCORE_ATOL = 1e-2
N_IMAGES = 4


def _testdir(path):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(N_IMAGES):
        name = f"img_{i}.jpg"
        imsave(str(path / name), rng.uniform(0, 255, (240, 320, 3)).astype(np.uint8))
        rows.append({"FACE_ID": i, "FILE": name, "SUBJECT_ID": i, "FACE_X": 50,
                     "FACE_Y": 60, "FACE_WIDTH": 40, "FACE_HEIGHT": 40})
    pd.DataFrame(rows).to_csv(path / "validation.csv", index=False)
    return path


def _conf(cls, testdir, out, **kw):
    conf = cls(mode="test", test_path=str(testdir), output_file_path=str(out),
               weights_path="does_not_exist.weights", **kw)
    conf.nn_arch.image_size = 64
    conf.hps.face_conf_th = 0.05  # random trunk scores hover near 0.25
    conf.hps.batch_size = 2
    return conf


def _letterboxed(testdir):
    files = sorted(str(p) for p in testdir.glob("*.jpg"))
    return np.asarray([letterbox_host(imread(f) / 255, 64, "cubic")[0]
                       for f in files], np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("int8")
    testdir = _testdir(tmp_path_factory.mktemp("set"))
    lb = _letterboxed(testdir)

    jfd = JaxPipeline(_conf(JaxFdConf, testdir, tmp / "jax_test.csv"),
                      precision="int8")
    params, state = FaceDetectorModel(image_size=64, device="cpu").init_params(0)
    jfd.params, jfd.state = darknet.perturb_batchnorm(params, state, jfd.model.ops, 1)
    # A trainmeta pin of full int8, as a loaded checkpoint's sidecar would
    # set it: one self-check candidate instead of the eager six-tail ladder.
    jfd._ckpt_int8_tail = 0
    jfd.calibrate_int8(lb)
    jfd.test()

    ckpt = str(tmp / "fd.pt")
    save_checkpoint(ckpt, params_from_jax(jfd.params, jfd.state), meta={})
    pfd = port_fd.FaceDetectorPipeline(
        _conf(FdConf, testdir, tmp / "port_test.csv", model_loading=True,
              model_path=ckpt, int8_pallas_blocks=True),
        precision="int8", device="cpu")
    pfd._qparams = quant.to_device(qparams_from_jax(jfd._qparams), "cpu")
    launches = (conv_int8.launches, block_int8.launches)
    pfd.test()
    assert (conv_int8.launches, block_int8.launches) == launches  # plain versions
    return dict(tmp=tmp, testdir=testdir, lb=lb, jfd=jfd, pfd=pfd, ckpt=ckpt)


def _read_csv(path):
    rows = [line.split(",") for line in open(path).read().splitlines()]
    out = []
    for r in rows:
        x, y, w, h = (float(v) for v in r[1:5])
        out.append((r[0], np.asarray([x, y, x + w, y + h]), float(r[5])))
    return out


def test_solution_csv_matches_jax(runs):
    want = _read_csv(runs["tmp"] / "jax_test.csv")
    got = _read_csv(runs["tmp"] / "port_test.csv")
    assert want, "the synthetic set must produce detections at face_conf_th 0.05"
    assert [r[0] for r in got] == [r[0] for r in want]  # files, order, row counts
    for (_, gb, gs), (_, wb, ws) in zip(got, want):
        np.testing.assert_allclose(gb, wb, rtol=0, atol=EDGE_ATOL)
        assert abs(gs - ws) <= SCORE_ATOL


def test_trunk_is_bit_exact_and_head_close(runs):
    jfd, pfd, lb = runs["jfd"], runs["pfd"], runs["lb"]
    want_trunk = np.asarray(jax.jit(lambda x: jax_quant.apply_graph_quant(
        jfd._qparams, x, jfd.model.ops)["trunk"])(lb))
    want_head = np.asarray(jax.jit(lambda x: jfd.model.apply_quant(jfd._qparams, x))(lb))
    for fused in (True, False):
        got = quant.apply_graph_quant(pfd._qparams, torch.from_numpy(lb),
                                      pfd.model.ops, fused_blocks=fused)["trunk"]
        np.testing.assert_array_equal(got.numpy(), want_trunk)
    head = pfd.model.apply_quant(pfd._qparams, torch.from_numpy(lb), fused_blocks=True)
    assert head.shape == (N_IMAGES, 2, 2, 6)
    err = float(np.abs(head.numpy() - want_head).max())
    assert err <= HEAD_TOL * float(np.abs(want_head).max()), err


def test_port_calibration_follows_jax(runs, tmp_path):
    """The port's own calibrate_int8 on the same letterboxed batch and the
    same pin: scales close to the JAX package's, the same serving tail and
    self-check error."""
    jfd, lb = runs["jfd"], runs["lb"]
    ckpt = str(tmp_path / "pin0.pt")
    save_checkpoint(ckpt, torch.load(runs["ckpt"], weights_only=True),
                    meta={"int8_tail": 0})
    pfd = port_fd.FaceDetectorPipeline(
        _conf(FdConf, runs["testdir"], tmp_path / "calib.csv",
              model_loading=True, model_path=ckpt),
        precision="int8", device="cpu")
    pfd.calibrate_int8(lb)
    assert pfd.int8_tail_chosen == jfd.int8_tail_chosen
    assert np.isfinite(pfd.int8_calib_err)
    assert pfd.int8_calib_err == pytest.approx(jfd.int8_calib_err, abs=0.05)
    for g, w in zip(pfd._qparams["act_scales"], jfd._qparams["act_scales"]):
        np.testing.assert_allclose(g, w, rtol=1e-4)


def test_auto_calibration_on_the_first_batch(runs, tmp_path):
    """test() calibrates on its first batch, as the JAX pipeline does, and
    detect_batch_fused on up to 32 letterboxed images."""
    conf = _conf(FdConf, runs["testdir"], tmp_path / "auto.csv",
                 model_loading=True, model_path=runs["ckpt"], int8_pallas_blocks=True)
    pfd = port_fd.FaceDetectorPipeline(conf, precision="int8", device="cpu")
    pfd.test()
    assert pfd.int8_tail_chosen in (0, 2, 4, 5, 6, 8)
    rows = _read_csv(tmp_path / "auto.csv")
    assert len({r[0] for r in rows}) == N_IMAGES

    fused = port_fd.FaceDetectorPipeline(conf, precision="int8", device="cpu")
    files = sorted(str(p) for p in runs["testdir"].glob("*.jpg"))
    ims = [imread(f) for f in files]
    cands, counts = fused.detect_batch_fused(
        np.stack(ims), [letterbox_geometry(*im.shape[:2], 64) for im in ims])
    assert fused._qparams is not None and fused.int8_tail_chosen in (0, 2, 4, 5, 6, 8)
    assert cands.shape[::2] == (N_IMAGES, 6) and counts.shape == (N_IMAGES,)


@pytest.mark.parametrize("meta,tail", [({"int8_tail": 3}, 3), ({"qat": True}, 0),
                                       ({"qat": True, "int8_tail": 5}, 5)])
def test_trainmeta_pin_decides_the_tail(runs, tmp_path, meta, tail):
    """The JAX precedence: a measured pin first, then a QAT checkpoint means
    full int8, then the ladder."""
    ckpt = str(tmp_path / "pinned.pt")
    save_checkpoint(ckpt, torch.load(runs["ckpt"], weights_only=True), meta={})
    update_train_meta(ckpt, **meta)
    pfd = port_fd.FaceDetectorPipeline(
        _conf(FdConf, runs["testdir"], tmp_path / "x.csv", model_loading=True,
              model_path=ckpt), precision="int8", device="cpu")
    pfd.calibrate_int8(runs["lb"])
    assert pfd.int8_tail_chosen == tail
    if tail:
        assert pfd._qparams["tail_start"] == quant.tail_start_index(pfd.model.ops, tail)
    else:
        assert "tail_start" not in pfd._qparams


def test_fixed_tail_and_islands_skip_the_self_check(runs, tmp_path):
    pfd = port_fd.FaceDetectorPipeline(
        _conf(FdConf, runs["testdir"], tmp_path / "x.csv", model_loading=True,
              model_path=runs["ckpt"], int8_bf16_tail=2, int8_bf16_ops=(14,)),
        precision="int8", device="cpu")
    pfd.calibrate_int8(runs["lb"])
    assert pfd.int8_tail_chosen == 2 and not hasattr(pfd, "int8_calib_err")
    assert pfd._qparams["bf16_ops"] == [14]
    cands, counts = pfd.detect_batch(runs["lb"])
    assert np.isfinite(cands).all() and counts.shape == (N_IMAGES,)


@pytest.mark.parametrize("knob,value", [
    ("int8_bias_correct", True), ("int8_calib_percentile", "msegrid")])
def test_bias_correct_and_msegrid_knobs_calibrate(runs, tmp_path, knob, value):
    """The two calibration knobs reach quantize_folded: the biases move by
    the measured correction, or the scales are the msegrid calibrator's."""
    kw = dict(model_loading=True, model_path=runs["ckpt"], int8_tail_auto=False,
              int8_calib_percentile=99.99)
    plain = port_fd.FaceDetectorPipeline(
        _conf(FdConf, runs["testdir"], tmp_path / "x.csv", **kw),
        precision="int8", device="cpu")
    plain.calibrate_int8(runs["lb"])
    kw[knob] = value
    pfd = port_fd.FaceDetectorPipeline(
        _conf(FdConf, runs["testdir"], tmp_path / "x.csv", **kw),
        precision="int8", device="cpu")
    pfd.calibrate_int8(runs["lb"])
    if knob == "int8_bias_correct":
        assert not torch.equal(pfd._qparams["conv_0"]["bias"], plain._qparams["conv_0"]["bias"])
    else:
        want = quant.calibrate_folded(pfd.model.fold(), torch.as_tensor(runs["lb"][:16]),
                                      pfd.model.ops, percentile="msegrid")
        for g, w in zip(pfd._qparams["act_scales"], want):
            np.testing.assert_array_equal(g, w)
    cands, counts = pfd.detect_batch(runs["lb"])
    assert np.isfinite(cands).all() and counts.shape == (N_IMAGES,)


def test_default_device_is_the_card(runs, monkeypatch, tmp_path):
    """No device argument means the CUDA card; without one the entry points
    raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = _conf(FdConf, runs["testdir"], tmp_path / "x.csv")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_fd.FaceDetectorPipeline(conf, precision="int8")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_fd.main([f"fd_conf.test_path={runs['testdir']}",
                      "fd_conf.mode=test", "fd_conf.nn_arch.image_size=64"])
    assert port_fd.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port_fd.resolve_device(None) == torch.device("cuda")
    os.environ.get("HOME")  # the check itself touches no file
