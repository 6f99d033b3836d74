"""The port's int8 quantization (models/quant.py) vs the JAX package's.

Same numpy weights on both sides: the JAX init with every BN's
gamma/beta/mean/var perturbed from a seed (test_torch_folded.perturbed_params),
at 64², the full trunk. The int8 walk runs on qparams the JAX package made
(`convert.qparams_from_jax`), so the two programs see the same integers.

Tolerances:
- calibrate_folded: scales rtol 1e-4 per channel. They come from two f32
  forwards whose convs sum in another order (1e-5 of max |activation|, see
  test_torch_folded.py), so they are close, not bit-identical;
- quantize_folded on the JAX package's scales: bit-exact (host numpy);
- apply_graph_quant on the int8 trunk: bit-exact against the jitted JAX
  program (the same int32 sums, the epilogue FMAs rounded once);
- the bf16 tail and bf16 islands: 2e-2 of max |ref| (test_torch_folded's
  bf16 bound; an island's bf16 conv may move a requant by one step).
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.models import darknet as jax_darknet
from face_vijnana_yolov3_tpu.models import quant as jax_quant
from face_vijnana_yolov3_tpu.models.detector import FaceDetectorModel as JaxModel
from face_vijnana_yolov3_tpu.ops.postprocess import (
    FacePostprocessConfig as JaxPpConfig,
)
from face_vijnana_yolov3_tpu_torch.convert import params_from_jax, qparams_from_jax
from face_vijnana_yolov3_tpu_torch.models import darknet, quant
from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
from face_vijnana_yolov3_tpu_torch.ops.postprocess import FacePostprocessConfig

from test_torch_folded import perturbed_params
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)

SCALE_RTOL = 1e-4
BF16_TOL = 2e-2


@pytest.fixture(scope="module")
def setup():
    jm = JaxModel(image_size=64)
    params, state = perturbed_params(jm, 0)
    folded = jax.device_get(jm.fold(params, state))
    pm = FaceDetectorModel(image_size=64, device="cpu")
    pm.load_state_dict(params_from_jax(params, state))
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    return jm, folded, pm, x


def _jit_trunk(qp, x, ops, out="trunk", **kw):
    return np.asarray(jax.jit(
        lambda xx: jax_quant.apply_graph_quant(qp, xx, ops, **kw)[out])(x))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))


@pytest.mark.parametrize("percentile", [None, 99.99, "auto"])
def test_calibrate_folded_matches_jax(setup, percentile):
    jm, folded, pm, x = setup
    want = jax_quant.calibrate_folded(folded, x, jm.ops, percentile=percentile)
    got = quant.calibrate_folded(pm.fold(), torch.from_numpy(x), jm.ops,
                                 percentile=percentile)
    assert len(got) == len(want) == len(jm.ops) + 1
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=SCALE_RTOL, atol=0)


def test_percentiles_follow_jnp_percentile():
    """The order-statistic interpolation against jnp.percentile as the
    jitted calibration computes it, on columns with ties, a hot outlier and
    an odd count. (Eager jnp.percentile rounds the position q·(n−1) one ULP
    apart at some q; jit folds the constants. The final interpolation may
    be one FMA apart: rtol 1e-6.)"""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    a = np.abs(rng.standard_t(3, (4099, 5))).astype(np.float32)
    a[:40, 1] = 2.5  # ties
    a[7, 3] = 1e4  # lone outlier
    for p in (99.99, 99.9, 50.0, 0.0, 100.0):
        want = np.asarray(jax.jit(lambda v, p=p: jnp.percentile(v, p, axis=0))(a))
        got = quant._percentiles(torch.from_numpy(a), (p,))[0].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        np.testing.assert_allclose(got, np.percentile(a, p, axis=0), rtol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"bf16_tail_blocks": 2},
                                {"bf16_ops": (14, 40)}])
def test_quantize_folded_on_jax_scales_is_bit_exact(setup, kw):
    jm, folded, pm, x = setup
    scales = jax_quant.calibrate_folded(folded, x, jm.ops)
    want = qparams_from_jax(jax_quant.quantize_folded(
        folded, None, jm.ops, act_scales=scales, **kw))
    got = quant.quantize_folded(pm.fold(), None, jm.ops, act_scales=scales, **kw)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        if name == "act_scales":
            assert all(np.array_equal(a, b) for a, b in zip(g, w))
        elif name in ("tail_start", "bf16_ops"):
            assert g == w
        elif name in ("tail", "bf16"):
            assert sorted(g) == sorted(w)
            for c in w:
                for k in ("kernel", "bias"):
                    assert torch.equal(g[c][k], w[c][k]), (name, c, k)
        else:
            assert sorted(g) == sorted(w)
            for k, t in w.items():
                assert g[k].dtype == t.dtype and torch.equal(g[k], t), (name, k)


@pytest.mark.parametrize("fused_blocks", [False, True])
def test_full_trunk_is_bit_exact(setup, fused_blocks):
    """The whole int8 trunk at 64², with the 20 eligible residual blocks
    through block_int8's plain version or the stock convs, against the
    jitted JAX program (stock, and its Pallas blocks in interpret mode)."""
    jm, folded, _, x = setup
    qp = jm.quantize(folded, x)
    want = _jit_trunk(qp, x, jm.ops)
    if fused_blocks:
        np.testing.assert_array_equal(
            _jit_trunk(qp, x, jm.ops, pallas_blocks=True, pallas_interpret=True), want)
    got = quant.apply_graph_quant(qparams_from_jax(qp), torch.from_numpy(x),
                                  jm.ops, fused_blocks=fused_blocks)["trunk"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # most of the trunk output is live, not clipped or zero
    q = np.round(want / qp["act_scales"][-1].astype(np.float32))
    assert (q != 0).mean() > 0.5 and (np.abs(q) < 127).mean() > 0.9


@pytest.mark.parametrize("percentile", [None, 99.99])
def test_unfused_residual_is_bit_exact(setup, percentile):
    """fuse_residual=False: every add is a separate dequant-add-requant."""
    jm, folded, _, x = setup
    qp = jm.quantize(folded, x, percentile=percentile)
    want = _jit_trunk(qp, x, jm.ops, fuse_residual=False)
    got = quant.apply_graph_quant(qparams_from_jax(qp), torch.from_numpy(x),
                                  jm.ops, fuse_residual=False)["trunk"]
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_tail_matches_jax(setup):
    jm, folded, _, x = setup
    qp = jm.quantize(folded, x, bf16_tail_blocks=3)
    pqp = qparams_from_jax(qp)
    # the int8 walk up to the cut is exact
    cut = list(jm.ops[: qp["tail_start"]]) + [("output", "__cut")]
    no_tail = {k: v for k, v in qp.items() if k not in ("tail", "tail_start")}
    want_cut = _jit_trunk(no_tail, x, cut, out="__cut")
    got_cut = quant.apply_graph_quant(
        {k: v for k, v in pqp.items() if k not in ("tail", "tail_start")},
        torch.from_numpy(x), cut)["__cut"]
    np.testing.assert_array_equal(got_cut.numpy(), want_cut)
    # then folded bf16 for the last three blocks
    want = _jit_trunk(qp, x, jm.ops)
    got = quant.apply_graph_quant(pqp, torch.from_numpy(x), jm.ops,
                                  fused_blocks=True)["trunk"]
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("bf16_ops", [(14,), (14, 40, 64), (6, 7)])
def test_bf16_islands_match_jax(setup, bf16_ops):
    jm, folded, _, x = setup
    qp = jm.quantize(folded, x, bf16_ops=bf16_ops)
    want = _jit_trunk(qp, x, jm.ops)
    got = quant.apply_graph_quant(qparams_from_jax(qp), torch.from_numpy(x),
                                  jm.ops, fused_blocks=True)["trunk"]
    _close(got, want, BF16_TOL)


def test_apply_quant_bf16_head_matches_jax(setup):
    jm, folded, pm, x = setup
    qp = jm.quantize(folded, x)
    want = np.asarray(jax.jit(lambda xx: jm.apply_quant(qp, xx))(x))
    for fused in (False, True):
        got = pm.apply_quant(qparams_from_jax(qp), torch.from_numpy(x),
                             fused_blocks=fused)
        assert got.shape == (2, 2, 2, 6) and got.dtype == torch.float32
        _close(got, want, BF16_TOL)


def test_graph_bookkeeping_matches_jax():
    for ops, jax_ops in ((darknet.trunk_graph(), jax_darknet.trunk_graph()),
                         (darknet.yolov3_graph(), jax_darknet.yolov3_graph())):
        assert ops == jax_ops
        assert quant._position_channels(ops, 3) == jax_quant._position_channels(ops, 3)
    ops = darknet.trunk_graph()
    for n in (1, 3, 8, 23):
        assert quant.tail_start_index(ops, n) == jax_quant.tail_start_index(ops, n)
    for bad in (0, 24):
        with pytest.raises(ValueError):
            quant.tail_start_index(ops, bad)
    with pytest.raises(ValueError, match="linear trunk"):
        quant.tail_start_index(darknet.yolov3_graph(), 1)
    # the 20 eligible blocks of stages 3-5, as the JAX walk finds them
    c = {i: n for i, n in enumerate(quant._position_channels(ops, 3))}
    for i, op in enumerate(ops):
        if op[0] == "save":
            assert (quant._block_match(ops, i, c[i])
                    == jax_quant._pallas_block_match(ops, i, c[i]))
    assert sum(quant._block_match(ops, i, c[i])
               for i, op in enumerate(ops) if op[0] == "save") == 20


def test_full_yolov3_graph_runs_restore_concat_upsample():
    """restore / concat / upsample routes of the 3-head graph, on the same
    JAX-made qparams: the int8 outputs are bit-exact."""
    ops = jax_darknet.yolov3_graph()
    params, state = jax_darknet.init_graph_params(ops, jax.random.PRNGKey(0))
    folded = jax.device_get(jax_darknet.fold_graph_params(params, state, ops))
    x = np.random.default_rng(4).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    qp = jax_quant.quantize_folded(folded, x, ops)
    want = jax.jit(lambda xx: jax_quant.apply_graph_quant(qp, xx, ops))(x)
    got = quant.apply_graph_quant(qparams_from_jax(qp), torch.from_numpy(x), ops,
                                  fused_blocks=True)
    assert sorted(got) == sorted(want) == ["yolo_106", "yolo_82", "yolo_94"]
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------- self-check


class _FakeModel:
    """tests/test_quant.py's stand-in: each tail's head error is fixed."""

    def __init__(self, errs):
        self.errs = errs
        self.quantize_calls = []

    def apply_folded(self, folded, x, compute_dtype=None):
        return np.ones((2, 4), np.float32)

    def quantize(self, folded, x, percentile=None, bf16_tail_blocks=0,
                 bias_correct=False):
        self.quantize_calls.append(bf16_tail_blocks)
        return {"tail": bf16_tail_blocks}

    def apply_quant(self, q, x):
        return np.ones((2, 4), np.float32) + self.errs[q["tail"]]


@pytest.mark.parametrize("errs", [
    {0: 0.01, 2: 0.01, 4: 0.01, 5: 0.01, 6: 0.01, 8: 0.01},
    {0: 0.5, 2: 0.3, 4: 0.05, 5: 0.2, 6: 0.2, 8: 0.2},
    {0: 0.5, 2: 0.45, 4: 0.48, 5: 0.47, 6: 0.46, 8: 0.47},
    {0: 0.06, 2: 0.045, 4: 0.05, 5: 0.05, 6: 0.05, 8: 0.05},
    {0: 0.17, 2: 0.17, 4: 0.17, 5: 0.08, 6: 0.08, 8: 0.09},
], ids=["healthy", "tail4", "nothing_helps", "passing_wins", "cheapest_cluster"])
def test_quantize_autotail_choice_matches_jax(errs):
    jm, pm = _FakeModel(errs), _FakeModel(errs)
    _, want_tail, want_err = jax_quant.quantize_autotail(jm, None, None)
    _, got_tail, got_err = quant.quantize_autotail(pm, None, None)
    assert (got_tail, pm.quantize_calls) == (want_tail, jm.quantize_calls)
    assert got_err == want_err


def _heads():
    head = np.full((2, 13, 13, 6), -6.0, np.float32)  # sigmoid ~ 0: no boxes
    head[0, 6, 6] = [4.0, 0.5, 0.5, 0.3, 0.3, 4.0]
    head[1, 2, 9] = [4.0, 0.5, 0.5, 0.2, 0.2, 4.0]
    dead = head.copy()
    dead[0, 6, 6, 0] = -6.0
    dead[1, 2, 9, 0] = -6.0
    shifted = head.copy()
    shifted[0, 6, 6, 1:3] = [2.5, 2.5]  # the box moves about a cell
    many = np.random.default_rng(5).normal(0, 2, (2, 13, 13, 6)).astype(np.float32)
    noisy = many + np.random.default_rng(6).normal(0, 0.3, many.shape).astype(np.float32)
    none = np.full((2, 13, 13, 6), -6.0, np.float32)
    return [("same", head, head.copy()), ("dead", head, dead),
            ("shifted", head, shifted), ("noisy", many, noisy),
            ("none", none, none.copy()), ("none_vs_some", none, head)]


@pytest.mark.parametrize("case", range(6), ids=[c[0] for c in _heads()])
def test_detection_box_f1_scorer_matches_jax(case):
    _, ref, cand = _heads()[case]
    kw = dict(image_size=416, grid=13, conf_th=0.5, nms_iou_th=0.5, num_cands=60)
    want_fn = jax_quant.detection_box_f1_scorer(JaxPpConfig(**kw))
    got_fn = quant.detection_box_f1_scorer(FacePostprocessConfig(**kw), "cpu")
    inconclusive = case >= 4  # the reference detects nothing
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = got_fn(ref, cand)
    assert bool(seen) == inconclusive
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = want_fn(ref, cand)
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
    assert got_fn.inconclusive == want_fn.inconclusive == inconclusive


def test_unported_calibration_options_raise(setup):
    """Every calibration of the JAX package is ported (msegrid and bias
    correction: tests/test_torch_calib.py); what is left to refuse is a
    calibration name that neither package knows."""
    jm, _, pm, x = setup
    with pytest.raises(ValueError, match="msegrid"):
        quant.calibrate_folded(pm.fold(), torch.from_numpy(x), jm.ops,
                               percentile="bogus")
    with pytest.raises(ValueError, match="mutually exclusive"):
        quant.quantize_folded(pm.fold(), torch.from_numpy(x), jm.ops,
                              bias_correct=True, bf16_ops=(14,))


def test_to_device_takes_inverse_scales_in_float64():
    """1/scale in float64, then f32: an f32 reciprocal of the f32 scale
    rounds differently for some scales, which would flip requant LSBs."""
    rng = np.random.default_rng(7)
    s = rng.uniform(1e-4, 1e-1, 4096) / 127.0
    qp = quant.to_device({"act_scales": [s]}, "cpu")
    assert torch.equal(qp["act_inv_f32"][0], torch.from_numpy((1.0 / s).astype(np.float32)))
    assert torch.equal(qp["act_scales_f32"][0], torch.from_numpy(s.astype(np.float32)))
    f32_recip = (1.0 / s.astype(np.float32)).astype(np.float32)
    assert (f32_recip != (1.0 / s).astype(np.float32)).any()


@pytest.mark.slow
def test_full_trunk_416_is_bit_exact():
    """The serving width: one 416² image through the full int8 trunk with
    the fused blocks on, against the jitted JAX program (calibrated on it)."""
    jm = JaxModel(image_size=416)
    params, state = perturbed_params(jm, 0)
    folded = jax.device_get(jm.fold(params, state))
    x = np.random.default_rng(3).uniform(0, 1, (1, 416, 416, 3)).astype(np.float32)
    qp = jm.quantize(folded, x, percentile="auto")
    want = _jit_trunk(qp, x, jm.ops)
    got = quant.apply_graph_quant(qparams_from_jax(qp), torch.from_numpy(x),
                                  jm.ops, fused_blocks=True)["trunk"]
    assert got.shape == (1, 13, 13, 1024)
    np.testing.assert_array_equal(got.numpy(), want)
