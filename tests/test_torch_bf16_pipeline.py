"""The bf16 serving slice: the port's FaceDetectorPipeline(precision=
"bfloat16") vs the JAX package's, on the CPU.

The guard-depth rules are the JAX package's tests/test_quant.py cases
(test_pipeline_bf16_front_auto, test_bf16_front_auto_defers_on_small_batch,
test_bf16_front_auto_inconclusive_scorer_keeps_guard) at 64²: "auto" pins
a depth in {0, 1, 2}, a scorer that fails everything pins 2, an int is
used as-is, a batch under 16 images defers unpinned, an inconclusive
scorer pins 2 after 3 probes.

Numbers: both pipelines hold the same weights (seeded random kernels with
seeded BN statistics, models/darknet.perturb_batchnorm). The head the port
serves at guard depth 0/1/2 is held against the JAX package's jitted
`apply_folded` within 2e-2 of max |head| (the bf16 bound of
test_torch_folded.py: each of the 52 bf16 convs rounds its sums in an
order-dependent way). test() on four seeded 240x320 JPEGs: the same files
and row counts, box edges within 5 px of the originals, scores within 1e-2
(test_torch_int8_pipeline.py's bounds for a head within that tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.api.config import FdConf as JaxFdConf
from face_vijnana_yolov3_tpu.api.face_detection import (
    FaceDetectorPipeline as JaxPipeline,
)
from face_vijnana_yolov3_tpu.models.detector import FaceDetectorModel as JaxModel
from face_vijnana_yolov3_tpu_torch.api import face_detection as port_fd
from face_vijnana_yolov3_tpu_torch.api.config import FdConf
from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
from face_vijnana_yolov3_tpu_torch.core.checkpoints import save_checkpoint
from face_vijnana_yolov3_tpu_torch.models import darknet, quant
from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_geometry
from face_vijnana_yolov3_tpu_torch.ops.postprocess import face_postprocess_batch
from test_torch_int8_pipeline import (
    EDGE_ATOL,
    HEAD_TOL,
    N_IMAGES,
    SCORE_ATOL,
    _conf,
    _read_csv,
    _testdir,
)
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bf16")
    params, state = FaceDetectorModel(image_size=64, device="cpu").init_params(0)
    params, state = darknet.perturb_batchnorm(params, state, darknet.trunk_graph(), 1)
    ckpt = str(tmp / "fd.pt")
    save_checkpoint(ckpt, params_from_jax(params, state), meta={})
    return dict(params=params, state=state, ckpt=ckpt,
                testdir=_testdir(tmp_path_factory.mktemp("set")))


def _port(weights, tmp_path, front, image_size=64):
    conf = _conf(FdConf, weights["testdir"], tmp_path / "port.csv",
                 model_loading=True, model_path=weights["ckpt"])
    conf.bf16_f32_front = front
    conf.nn_arch.image_size = image_size
    return port_fd.FaceDetectorPipeline(conf, precision="bfloat16", device="cpu")


def _images(n, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, 64, 64, 3)).astype(np.float32)


def test_auto_pins_a_depth(weights, tmp_path):
    fd = _port(weights, tmp_path, "auto")
    x = _images(16, 0)
    for _ in range(3):  # an inconclusive scorer defers up to 3 times
        fd.detect_batch(x)
        if hasattr(fd, "bf16_front_chosen"):
            break
    assert fd.bf16_front_chosen in (0, 1, 2)
    assert fd._bf16_front_depth() == fd.bf16_front_chosen
    assert fd.bf16_front_err is not None


def test_failing_scorer_pins_depth_2(weights, tmp_path, monkeypatch):
    monkeypatch.setattr(quant, "detection_box_f1_scorer",
                        lambda cfg, device="cpu": (lambda ref, cand: 1.0))
    fd = _port(weights, tmp_path, "auto")
    fd.detect_batch(_images(16, 0))
    assert fd.bf16_front_chosen == 2 and fd.bf16_front_err == 1.0


def test_explicit_depth_is_honoured(weights, tmp_path, monkeypatch):
    def no_probe(*a, **k):
        raise AssertionError("an int depth must not probe")

    monkeypatch.setattr(port_fd.FaceDetectorPipeline, "autoselect_bf16_front", no_probe)
    fd = _port(weights, tmp_path, 1)
    assert fd._bf16_front_depth() == 1
    cands, counts = fd.detect_batch(_images(16, 0))
    assert cands.shape == (16, 4, 6) and not hasattr(fd, "bf16_front_chosen")


def test_small_batch_defers_unpinned(weights, tmp_path, monkeypatch):
    fd = _port(weights, tmp_path, "auto")
    fd.detect_batch(_images(1, 1))
    assert not hasattr(fd, "bf16_front_chosen")
    assert fd._bf16_front_depth() == 2
    monkeypatch.setattr(quant, "detection_box_f1_scorer",
                        lambda cfg, device="cpu": (lambda ref, cand: 0.0))
    fd.detect_batch(_images(16, 2))
    assert fd.bf16_front_chosen == 0


def test_inconclusive_scorer_pins_2_after_3_probes(weights, tmp_path, monkeypatch):
    def factory(cfg, device="cpu"):
        def scorer(ref, cand):
            scorer.inconclusive = True  # the zero-detection path
            return 0.0                  # a vacuous pass

        scorer.inconclusive = False
        return scorer

    monkeypatch.setattr(quant, "detection_box_f1_scorer", factory)
    fd = _port(weights, tmp_path, "auto")
    x = _images(16, 3)
    for i in range(3):
        assert fd.autoselect_bf16_front(x) == (2, None if i < 2 else 0.0)
        assert hasattr(fd, "bf16_front_chosen") == (i == 2)
    assert fd.bf16_front_chosen == 2


def test_fused_letterbox_probes_on_the_first_batch(weights, tmp_path, monkeypatch):
    monkeypatch.setattr(quant, "detection_box_f1_scorer",
                        lambda cfg, device="cpu": (lambda ref, cand: 0.0))
    fd = _port(weights, tmp_path, "auto")
    staged = np.random.default_rng(4).integers(0, 256, (16, 48, 80, 3), dtype=np.uint8)
    cands, counts = fd.detect_batch_fused(staged, [letterbox_geometry(48, 80, 64)] * 16)
    assert fd.bf16_front_chosen == 0 and counts.shape == (16,)


@pytest.mark.parametrize("depth,size,n", [
    (0, 64, 4), (1, 64, 4), (2, 64, 4), pytest.param(0, 416, 2, marks=pytest.mark.slow)])
def test_served_head_matches_jax(weights, tmp_path, monkeypatch, depth, size, n):
    """The head `_detect` serves at each guard depth vs the JAX package's
    jitted apply_folded on the same weights, and `_detect`'s candidates are
    the postprocess of that head."""
    heads = []

    def recording(head, cfg):
        heads.append(head)
        return face_postprocess_batch(head, cfg)

    monkeypatch.setattr(port_fd, "face_postprocess_batch", recording)
    x = np.random.default_rng(5).uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    fd = _port(weights, tmp_path, depth, image_size=size)
    cands, counts = fd.detect_batch(x)
    jm = JaxModel(image_size=size)
    folded = jm.fold(weights["params"], weights["state"])
    want = np.asarray(jax.jit(lambda f, xi: jm.apply_folded(
        f, xi, compute_dtype=jnp.bfloat16, f32_front_blocks=depth))(folded, x))
    got = heads[0].numpy()
    assert got.shape == want.shape == (n, size // 32, size // 32, 6)
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= HEAD_TOL * float(np.abs(want).max()), err
    want_c, want_n = face_postprocess_batch(heads[0], fd._pp_cfg)
    np.testing.assert_array_equal(cands, want_c.numpy())
    np.testing.assert_array_equal(counts, want_n.numpy())


def test_probe_scores_the_served_program(weights, tmp_path, monkeypatch):
    """The candidate head the probe scores at the chosen depth is
    torch.equal to the head `_detect` then serves on the same images."""
    scored, served = [], []
    real_factory = quant.detection_box_f1_scorer

    def factory(cfg, device="cpu"):
        real = real_factory(cfg, device)

        def scorer(ref, cand):
            scored.append(np.array(cand))
            err = real(ref, cand)
            scorer.inconclusive = real.inconclusive
            return err

        scorer.inconclusive = False
        return scorer

    def recording(head, cfg):
        served.append(head.numpy().copy())
        return face_postprocess_batch(head, cfg)

    monkeypatch.setattr(quant, "detection_box_f1_scorer", factory)
    monkeypatch.setattr(port_fd, "face_postprocess_batch", recording)
    fd = _port(weights, tmp_path, "auto")
    x = _images(16, 6)
    for _ in range(3):
        scored.clear()
        served.clear()
        fd.detect_batch(x)
        if hasattr(fd, "bf16_front_chosen"):
            break
    depth = fd.bf16_front_chosen
    assert len(scored) == depth + 1 and len(served) == 1
    assert torch.equal(torch.from_numpy(scored[depth]), torch.from_numpy(served[0]))


def test_solution_csv_matches_jax(weights, tmp_path):
    """test() at guard depth 2 in both packages on the same JPEGs."""
    jfd = JaxPipeline(_conf(JaxFdConf, weights["testdir"], tmp_path / "jax.csv",
                            bf16_f32_front=2), precision="bfloat16")
    jfd.params, jfd.state = weights["params"], weights["state"]
    jfd.test()
    pfd = _port(weights, tmp_path, 2)
    pfd.test()
    want = _read_csv(tmp_path / "jax.csv")
    got = _read_csv(tmp_path / "port.csv")
    assert want, "the synthetic set must produce detections at face_conf_th 0.05"
    assert [r[0] for r in got] == [r[0] for r in want]
    assert len({r[0] for r in got}) == N_IMAGES
    for (_, gb, gs), (_, wb, ws) in zip(got, want):
        np.testing.assert_allclose(gb, wb, rtol=0, atol=EDGE_ATOL)
        assert abs(gs - ws) <= SCORE_ATOL


def test_bf16_serves_on_the_card_by_default(weights, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = _conf(FdConf, weights["testdir"], tmp_path / "x.csv")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_fd.FaceDetectorPipeline(conf, precision="bfloat16")
    conf.bf16_front_mode = "int8"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_fd.FaceDetectorPipeline(conf, precision="bfloat16")
    hybrid = port_fd.FaceDetectorPipeline(conf, precision="bfloat16", device="cpu")
    assert hybrid._hybrid_front and hybrid._qparams is None
