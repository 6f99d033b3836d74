"""Distillation QAT in the port (models/qat.py, train/optimizer.OptaxAdam,
FaceDetectorPipeline's `int8_qat_steps`) vs the JAX package's, on the CPU.

The graphs are the JAX package's tests/test_qat.py ones: the 16² tiny
residual graph (worst-case int8 sum 127·127·9·8 < 2^24, so f32 sums of
the integer-valued operands are exact) and the stride-2 / concat /
upsample block graph; the weights are the port's seeded numpy init in the
JAX layout with every BN gamma nudged by +0.7, folded by the JAX package
and carried across with `convert.folded_from_jax`.

Tolerances: the fake-quant forward is bit-exact, to the port's own int8
serving program (`apply_graph_quant`) and to the JAX `apply_graph_fakequant`.
Distillation over 5 steps: losses within 1e-5 relative and refined leaves
within lr / 10 of JAX's. The two packages' convolution gradients differ in
summation order (a few ULP); Adam normalises each element's update to
about lr whatever its gradient's size, so the one way the leaves could
part by an lr-sized step is a gradient near zero whose sign the two
disagree on. None is that small here, so the leaves agree far inside lr /
10 (measured: 6e-8 at lr 1e-3), and a sign flip would show as a failure.
The pipeline run (64², the whole trunk; the two cases that run the JAX
pipeline are marked slow, its distillation step takes ~40 s to compile):
the frozen act_scales within 1e-4 relative of JAX's
(test_torch_int8_pipeline.py's calibration bound). Its distillation, repeated on the JAX run's own weights and scales: losses
within 1e-3 relative (f32 teacher and student convs in two summation
orders through 75 layers); on this trunk some gradients are near zero, so
a few leaves (0.05 % measured) take an lr-sized step apart: every leaf
within 2 lr a step, 99.9 % within lr / 10; and at least 99.9 % of the int8
kernel entries quantized from the refined leaves equal to JAX's (a leaf
moved across a rounding midpoint quantizes to the neighbour).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.models import darknet as jax_darknet
from face_vijnana_yolov3_tpu.models import qat as jax_qat
from face_vijnana_yolov3_tpu.models import quant as jax_quant
from face_vijnana_yolov3_tpu_torch.api import face_detection as port_fd
from face_vijnana_yolov3_tpu_torch.api.config import FdConf
from face_vijnana_yolov3_tpu_torch.convert import folded_from_jax
from face_vijnana_yolov3_tpu_torch.models import darknet, qat, quant
from face_vijnana_yolov3_tpu_torch.train.optimizer import OptaxAdam
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)
_conv = darknet._conv


def _tiny_graph():
    return [_conv(0, 8), ("save", "b0"), _conv(1, 4, k=1), _conv(2, 8),
            ("add", "b0"), _conv(3, 6, bn=False, leaky=False), ("output", "out")]


def _block_graph():
    return [_conv(0, 8), ("save", "hi"), _conv(1, 8, stride=2), _conv(2, 4, k=1),
            ("upsample",), ("concat", "hi"), _conv(3, 6, k=1, bn=False, leaky=False),
            ("output", "out")]


def _folded(ops, seed):
    """(JAX folded numpy tree, the port's folded tree) of the same weights."""
    params, state = darknet.init_graph_params(ops, seed)
    for k, v in params.items():
        if k.startswith("bnorm_"):
            v["gamma"] = v["gamma"] + 0.7
    jf = {k: {n: np.asarray(t) for n, t in v.items()}
          for k, v in jax_darknet.fold_graph_params(params, state, ops).items()}
    return jf, folded_from_jax(jf)


def _uniform(seed, shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    ops = _tiny_graph()
    jf, pf = _folded(ops, 0)
    images = _uniform(4, (8, 16, 16, 3))
    scales = [np.asarray(s, np.float64)
              for s in jax_quant.calibrate_folded(jf, jnp.asarray(images), ops)]
    return dict(ops=ops, jf=jf, pf=pf, images=images, scales=scales)


@pytest.mark.parametrize("graph", ["tiny", "block"])
def test_fakequant_equals_serving(graph):
    """The port's fake-quant head == the port's int8 serving program,
    bit for bit (test_qat.py:51, :63)."""
    ops = _tiny_graph() if graph == "tiny" else _block_graph()
    _jf, pf = _folded(ops, 0 if graph == "tiny" else 2)
    x = torch.from_numpy(_uniform(1, (2, 16, 16, 3)))
    q = quant.quantize_folded(pf, x, ops)
    served = quant.apply_graph_quant(q, x, ops)["out"]
    fq = qat.apply_graph_fakequant(pf, x, ops, q["act_scales"])["out"]
    assert torch.equal(fq, served), float((fq - served).abs().max())


@pytest.mark.parametrize("graph", ["tiny", "block"])
def test_fakequant_equals_jax(graph):
    """The same weights and scales through JAX's apply_graph_fakequant,
    jitted as its distill_folded runs it (qat.py:251): bit for bit."""
    ops = _tiny_graph() if graph == "tiny" else _block_graph()
    jf, pf = _folded(ops, 0 if graph == "tiny" else 2)
    x = _uniform(1, (2, 16, 16, 3))
    scales = [np.asarray(s, np.float64)
              for s in jax_quant.calibrate_folded(jf, jnp.asarray(x), ops)]
    got = qat.apply_graph_fakequant(pf, torch.from_numpy(x), ops, scales)["out"].numpy()
    jitted = np.asarray(jax.jit(lambda f, xx: jax_qat.apply_graph_fakequant(
        f, xx, ops, scales)["out"])(jf, jnp.asarray(x)))
    np.testing.assert_array_equal(got, jitted)


def test_fakequant_gradients_reach_every_leaf(tiny):
    """STE gradients reach every conv kernel and bias (test_qat.py:87), and
    the input's, through the fused-residual FMA."""
    ops, pf, scales = tiny["ops"], tiny["pf"], tiny["scales"]
    prm = {k: {n: t.clone().requires_grad_(True) for n, t in v.items()}
           for k, v in pf.items()}
    x = torch.from_numpy(tiny["images"][:2])
    target = qat.apply_graph_fakequant(pf, x, ops, scales)["out"] + 0.1
    loss = torch.mean(torch.square(qat.apply_graph_fakequant(prm, x, ops, scales)["out"]
                                   - target))
    leaves = [t for v in prm.values() for t in v.values()]
    grads = torch.autograd.grad(loss, leaves)
    assert len(grads) == 8
    assert all(float(g.abs().max()) > 0 for g in grads), [float(g.abs().max()) for g in grads]


def test_conv_exactness_finds_inexact_sums(tiny, monkeypatch):
    """scripts/qat_conv_exactness: on the CPU every fake-quant conv of the
    tiny graph equals its exact sums by either route (all below 2^24), and
    a route one ulp off is caught on every element."""
    from face_vijnana_yolov3_tpu_torch.scripts import qat_conv_exactness as qce

    ops, pf, scales = tiny["ops"], tiny["pf"], tiny["scales"]
    x = torch.from_numpy(tiny["images"][:2])
    for route in (None, "cudnn", "native"):
        got = qce.conv_exactness(pf, x, ops, scales, route)
        assert got == dict(differ_within=0, differ_beyond=0, beyond=0,
                           elements=2 * 16 * 16 * (8 + 4 + 8 + 6), convs=4), (route, got)
    monkeypatch.setitem(qce.ROUTES, "off", lambda *a: torch.nextafter(
        qce._native(*a), torch.tensor(float("inf"))))
    got = qce.conv_exactness(pf, x, ops, scales, "off")
    assert got["differ_within"] == got["elements"] > 0
    assert qat._int_valued_conv is not qce.ROUTES["off"]  # restored


def test_ste_value_and_gradient():
    """z + (r − z) in this order, as JAX's z + stop_gradient(r − z): the
    same f32 values (including clipped and huge z) and a unit gradient."""
    z = torch.tensor([-1e9, -300.0, -127.5, -0.5, 0.5, 1.5, 2.5, 126.6, 3e7, 1e9],
                     requires_grad=True)
    got = qat._ste_round_clip(z)
    zj = jnp.asarray(z.detach().numpy())
    want = np.asarray(zj + jax.lax.stop_gradient(jnp.clip(jnp.round(zj), -127.0, 127.0) - zj))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (g,) = torch.autograd.grad(got.sum(), z)
    assert torch.equal(g, torch.ones_like(g))


def test_optax_adam_matches_optax():
    """OptaxAdam(lr) = optax.adam(lr) over 4 steps of the same gradients,
    within 1e-6 relative (f32, the two differ only in FMA contraction)."""
    import optax

    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(3, 5)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 10.0 ** -i
              for k, v in p0.items()} for i in range(4)]
    opt = optax.adam(1e-3)
    pj, sj = dict(p0), opt.init(p0)
    mine = OptaxAdam(1e-3)
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    st = mine.init(pt)
    for g in grads:
        uj, sj = opt.update(g, sj)
        pj = optax.apply_updates(pj, uj)
        ut, st = mine.update({k: torch.from_numpy(v) for k, v in g.items()}, st)
        pt = {k: pt[k] + ut[k] for k in pt}
        for k in p0:
            np.testing.assert_allclose(ut[k].numpy(), np.asarray(uj[k]), rtol=1e-6, atol=1e-12)
    for k in p0:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-6, atol=1e-9)
    assert int(st.count) == 4


@pytest.mark.parametrize("lr", [1e-3, 1e-5])
def test_distill_matches_jax(tiny, lr):
    """5 steps of distill_folded, same seed: losses within 1e-5 relative,
    refined leaves within lr / 10 (module docstring)."""
    ops, jf, pf, images, scales = (tiny[k] for k in ("ops", "jf", "pf", "images", "scales"))
    jr, jl = jax_qat.distill_folded(jf, images, ops, act_scales=scales, steps=5,
                                    batch_size=4, lr=lr, seed=3)
    pr, pl = qat.distill_folded(pf, images, ops, act_scales=scales, steps=5,
                                batch_size=4, lr=lr, seed=3)
    np.testing.assert_allclose(pl, np.asarray(jl, np.float64), rtol=1e-5)
    want = folded_from_jax({k: {n: np.asarray(t) for n, t in v.items()}
                            for k, v in jr.items()})
    for k in pf:
        for n in pf[k]:
            moved = float((pr[k][n] - pf[k][n]).abs().max())
            assert moved > lr / 2, (k, n, moved)  # every leaf trained
            np.testing.assert_allclose(pr[k][n].numpy(), want[k][n].numpy(),
                                       rtol=0, atol=lr / 10)


def test_distill_shrinks_gap_and_deploys_trained_program(tiny):
    """The recoverable gap of test_qat.py:106: from kernels perturbed by 5 %
    of their spread, 120 steps at lr 1e-3 halve the loss; the int8 program
    quantized from the refined kernels with the frozen scales equals the
    trained fake-quant program bit for bit, and is closer to the f32
    teacher than the perturbed start."""
    ops, pf, images, scales = tiny["ops"], tiny["pf"], tiny["images"], tiny["scales"]
    gen = torch.Generator().manual_seed(7)
    perturbed = {k: {n: t + 0.05 * t.std() * torch.randn(t.shape, generator=gen)
                     for n, t in v.items()} for k, v in pf.items()}
    refined, losses = qat.distill_folded(pf, images, ops, act_scales=scales, steps=120,
                                         batch_size=8, lr=1e-3, student_init=perturbed)
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    x = torch.from_numpy(images)
    q = quant.quantize_folded(refined, None, ops, act_scales=scales)
    served = quant.apply_graph_quant(q, x, ops)["out"]
    assert torch.equal(served, qat.apply_graph_fakequant(refined, x, ops, scales)["out"])
    teacher = darknet.apply_graph_folded(pf, x, ops, compute_dtype=torch.float32)["out"]
    start = quant.apply_graph_quant(quant.quantize_folded(perturbed, None, ops,
                                                          act_scales=scales), x, ops)["out"]
    mse_start = float(torch.mean(torch.square(start - teacher)))
    mse_qat = float(torch.mean(torch.square(served - teacher)))
    assert mse_qat < 0.5 * mse_start, (mse_start, mse_qat)


def test_distill_tail_blocks_freezes_front(tiny):
    """tail_blocks=1 trains only the convs from the last block opener on
    (conv_1..3 here) and leaves conv_0 bit-identical (test_qat.py:152)."""
    ops, pf, images, scales = tiny["ops"], tiny["pf"], tiny["images"], tiny["scales"]
    refined, _ = qat.distill_folded(pf, images, ops, act_scales=scales, steps=5,
                                    batch_size=8, lr=1e-3, tail_blocks=1)
    for n in ("kernel", "bias"):
        assert torch.equal(refined["conv_0"][n], pf["conv_0"][n])
    assert not torch.equal(refined["conv_3"]["kernel"], pf["conv_3"]["kernel"])


# ------------------------------------------------------------ the pipeline knob

def _pipe_conf(cls, **kw):
    conf = cls(weights_path="missing.weights", **kw)
    conf.nn_arch.image_size = 64
    return conf


@pytest.fixture(scope="module")
def port_qat():
    """The port's int8 pipeline with int8_qat_steps=2, calibrated on 6
    seeded 64² images."""
    images = _uniform(5, (6, 64, 64, 3))
    pfd = port_fd.FaceDetectorPipeline(_pipe_conf(FdConf, int8_qat_steps=2),
                                       precision="int8", device="cpu")
    params, state = pfd.model.init_params(0)
    params, state = darknet.perturb_batchnorm(params, state, pfd.model.ops, 1)
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax

    pfd.model.load_state_dict(params_from_jax(params, state))
    pfd.calibrate_int8(images)
    return dict(pfd=pfd, images=images, params=params, state=state)


def test_pipeline_qat_deploys_the_frozen_scales(port_qat):
    """calibrate_int8 with int8_qat_steps: full int8 (no tail ladder), and
    the act_scales calibrated on the first 16 images before the
    distillation deploy unchanged; its 2 losses are kept."""
    pfd, images = port_qat["pfd"], port_qat["images"]
    pq = pfd._qparams
    assert "tail_start" not in pq and pfd.int8_tail_chosen == 0
    assert len(pfd.int8_qat_losses) == 2
    want = quant.calibrate_folded(pfd.model.fold(), torch.from_numpy(images[:16]),
                                  pfd.model.ops)
    for g, w in zip(pq["act_scales"], want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def jax_qat_run(port_qat):
    """The JAX pipeline on the same weights and images with
    int8_qat_steps=2: what it handed its qat.distill_folded, what it got
    back, and its qparams."""
    from face_vijnana_yolov3_tpu.api.config import FdConf as JaxFdConf
    from face_vijnana_yolov3_tpu.api.face_detection import FaceDetectorPipeline as JaxFd

    jfd = JaxFd(_pipe_conf(JaxFdConf, int8_qat_steps=2), precision="int8")
    jfd.params, jfd.state = port_qat["params"], port_qat["state"]
    seen = {}
    real = jax_qat.distill_folded

    def spy(folded, images, ops, **kw):
        out = real(folded, images, ops, **kw)
        seen.update(folded=folded, kw=kw, refined=out[0], losses=out[1])
        return out

    jax_qat.distill_folded = spy
    try:
        jfd.calibrate_int8(port_qat["images"])
    finally:
        jax_qat.distill_folded = real
    return dict(jfd=jfd, **seen)


@pytest.mark.slow
def test_pipeline_qat_scales_follow_jax(port_qat, jax_qat_run):
    """The frozen scales within 1e-4 of the JAX pipeline's (~40 s: the
    JAX distillation step compiles)."""
    for g, w in zip(port_qat["pfd"]._qparams["act_scales"],
                    jax_qat_run["jfd"]._qparams["act_scales"]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4)


@pytest.mark.slow
def test_trunk_distillation_follows_jax(port_qat, jax_qat_run):
    """The distillation the JAX pipeline ran (the whole 64² trunk and the
    f32 head, tail_blocks 4, lr 1e-5), repeated by the port's distill_folded
    on the same folded weights and scales: losses within 1e-3 relative, the
    refined leaves within 2 lr a step and 99.9 % of them within lr / 10,
    and at least 99.9 % of the int8 kernel entries quantized from them
    equal to JAX's (module docstring)."""
    from face_vijnana_yolov3_tpu_torch.models.detector import head_conv

    j = jax_qat_run
    kw = j["kw"]
    assert (kw["steps"], kw["lr"], kw["tail_blocks"]) == (2, 1e-5, 4)
    jf = {k: {n: np.asarray(t) for n, t in v.items()} for k, v in j["folded"].items()}
    scales = [np.asarray(s, np.float64) for s in kw["act_scales"]]
    ops = port_qat["pfd"].model.ops
    refined, losses = qat.distill_folded(
        folded_from_jax(jf), port_qat["images"], ops, act_scales=scales,
        head_fn=lambda outs, prm: head_conv(outs["trunk"], prm["head"], torch.float32),
        steps=2, lr=1e-5, tail_blocks=4)
    np.testing.assert_allclose(losses, np.asarray(j["losses"], np.float64), rtol=1e-3)
    want = folded_from_jax({k: {n: np.asarray(t) for n, t in v.items()}
                            for k, v in j["refined"].items()})
    diff = np.concatenate([(refined[k][n] - want[k][n]).abs().numpy().ravel()
                           for k in want for n in want[k]])
    assert diff.max() <= 2 * 2 * 1e-5, diff.max()  # 2 lr a step, 2 steps
    assert np.mean(diff > 1e-6) <= 1e-3, np.mean(diff > 1e-6)
    got_q = quant.quantize_folded(refined, None, ops, act_scales=scales)
    want_q = jax_quant.quantize_folded(j["refined"], None, ops, act_scales=kw["act_scales"])
    same = total = 0
    for k, v in got_q.items():
        if k.startswith("conv_"):
            w = np.asarray(want_q[k]["kernel_q"]).transpose(3, 0, 1, 2)  # HWIO → OHWI
            same += int((v["kernel_q"].numpy() == w).sum())
            total += w.size
    assert same >= 0.999 * total, (same, total)


def test_pipeline_qat_knob_serves(port_qat):
    """The QAT knob calibrates and serves (test_qat.py:174): detect_batch
    runs the refined int8 program."""
    cands, counts = port_qat["pfd"].detect_batch(port_qat["images"][:4])
    assert cands.shape[0] == 4 and counts.shape == (4,) and np.isfinite(cands).all()


def test_qat_and_bf16_tail_mutually_exclusive():
    """QAT trains the full-int8 program; deploying its kernels under a bf16
    tail would ship a program that was never trained (test_qat.py:191)."""
    pfd = port_fd.FaceDetectorPipeline(
        _pipe_conf(FdConf, int8_qat_steps=1, int8_bf16_tail=2), precision="int8",
        device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        pfd.calibrate_int8(_uniform(5, (2, 64, 64, 3)))
