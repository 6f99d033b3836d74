"""The port's identifier (models/identifier.py), registry match
(ops/similarity.py) and identifier weight paths vs the JAX package's.

The same numpy weights (a seeded trunk with perturbed BN statistics and a
seeded dense1) and inputs go through both packages at 64², dense1_dim 8.
Tolerances, each measured on these seeds (in brackets) with room:
- f32 embed (eval BN; TF32 does not exist on the CPU): 1e-5 abs [8e-7];
- bf16 folded embed with the f32 front guard (depths 0 and 2), unit
  vectors: 3e-2 abs [8.3e-3 at depth 0, 2.5e-3 at 2]: both round every conv output to bf16 in other
  summation orders, and the JAX guard runs at Precision.HIGH (bf16x3),
  plain f32 here;
- int8: the trunk is bit-exact against the jitted JAX walk (an integer
  program), the embedding within 3e-2 abs [9.3e-4]: the bf16 dense1
  product of the same operands, summed in another order, may round to a
  neighbouring bf16 value;
- the training forward (batch-statistics BN) at f32: 1e-5 abs, the
  triplet loss rtol 1e-5;
- match_embeddings: the same indices, distances within 1e-6; ties and a
  NaN row as jnp.argmin / jnp.min.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.core import keras_import as jax_keras
from face_vijnana_yolov3_tpu.models import quant as jax_quant
from face_vijnana_yolov3_tpu.models.identifier import FaceIdentifierModel as JaxModel
from face_vijnana_yolov3_tpu.ops.similarity import match_embeddings as jax_match
from face_vijnana_yolov3_tpu_torch.convert import (
    identifier_params_from_jax,
    identifier_params_to_jax,
    qparams_from_jax,
)
from face_vijnana_yolov3_tpu_torch.core import keras_import
from face_vijnana_yolov3_tpu_torch.models import darknet, identifier, quant
from face_vijnana_yolov3_tpu_torch.models.identifier import FaceIdentifierModel
from face_vijnana_yolov3_tpu_torch.ops.similarity import match_embeddings
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)

S, D = 64, 8
F32_TOL = 1e-5
BF16_TOL = 3e-2


@pytest.fixture(scope="module")
def setup():
    jm = JaxModel(image_size=S, dense1_dim=D)
    params, state = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params = {k: dict(v) for k, v in params.items()}
    state = {k: dict(v) for k, v in state.items()}
    darknet.perturb_batchnorm(params, state, jm.ops, 7)
    pm = FaceIdentifierModel(image_size=S, dense1_dim=D, device="cpu")
    pm.load_state_dict(identifier_params_from_jax(params, state))
    x = np.random.default_rng(1).uniform(0, 1, (3, S, S, 3)).astype(np.float32)
    return jm, params, state, pm, x


# ------------------------------------------------------------------ match

def test_match_embeddings_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(37, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    reg = rng.normal(size=(11, 64)).astype(np.float32)
    reg /= np.linalg.norm(reg, axis=1, keepdims=True)
    want_i, want_d = (np.asarray(a) for a in jax_match(jnp.asarray(q), jnp.asarray(reg)))
    got_i, got_d = match_embeddings(torch.from_numpy(q), torch.from_numpy(reg))
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, atol=1e-6, rtol=0)


def test_match_embeddings_ties_and_nan_rows():
    """A query equidistant from two registry rows takes the first, as
    jnp.argmin does; a NaN query row gives index 0 and a NaN distance in
    both packages; a NaN registry row is the argmin of every query."""
    reg = np.array([[1, 0, 0], [0, 1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    q = np.array([[0.6, 0.6, 0], [1, 0, 0], [np.nan, 0, 0], [0, 0, 1]], np.float32)
    for r in (reg, np.concatenate([reg, np.full((1, 3), np.nan, np.float32)])):
        want_i, want_d = (np.asarray(a) for a in jax_match(jnp.asarray(q), jnp.asarray(r)))
        got_i, got_d = match_embeddings(torch.from_numpy(q), torch.from_numpy(r))
        np.testing.assert_array_equal(got_i.numpy(), want_i)
        np.testing.assert_array_equal(np.isnan(got_d.numpy()), np.isnan(want_d))
        ok = ~np.isnan(want_d)
        np.testing.assert_allclose(got_d.numpy()[ok], want_d[ok], atol=1e-6)
    assert want_i.tolist() == [4, 4, 0, 4]  # a NaN registry row wins
    got_i, _ = match_embeddings(torch.from_numpy(q), torch.from_numpy(reg))
    assert got_i.tolist() == [0, 0, 0, 3]  # ties and the duplicate row: the first


# ------------------------------------------------------------------ init / convert

def test_dense1_init_matches_jax():
    """init_dense1 gives the JAX init's dense1 when handed the numpy seed
    the JAX key yields (identifier.py:35-50)."""
    jm = JaxModel(image_size=S, dense1_dim=D)
    params, _ = jm.init(jax.random.PRNGKey(3))
    _, dense_rng = jax.random.split(jax.random.PRNGKey(3))
    seed = int(np.asarray(jax.random.key_data(dense_rng)).ravel()[-1]) & 0x7FFFFFFF
    got = identifier.init_dense1(seed, jm.flat_dim, D)
    np.testing.assert_array_equal(got["kernel"], np.asarray(params["dense1"]["kernel"]))
    np.testing.assert_array_equal(got["bias"], np.asarray(params["dense1"]["bias"]))


def test_identifier_params_round_trip(setup):
    _, params, state, pm, _ = setup
    back_p, back_s = identifier_params_to_jax(pm.state_dict())
    assert set(back_p) == set(params) and set(back_s) == set(state)
    for k in params:
        for f in params[k]:
            np.testing.assert_array_equal(back_p[k][f], params[k][f])
    assert pm.dense1.weight.shape == (D, (S // 32) ** 2 * 1024)


# ------------------------------------------------------------------ forwards

def test_embed_f32_matches_jax(setup):
    jm, params, state, pm, x = setup
    want, _ = jm.embed(params, state, jnp.asarray(x))
    got = pm.embed(torch.from_numpy(x))
    assert got.shape == (3, D)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= F32_TOL
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, atol=1e-6)


def test_flatten_order_is_keras_hwc(setup):
    """dense1's rows follow Keras' (H, W, C) Flatten: flattening the NCHW
    feature instead (the port's internal layout) gives another embedding,
    so the parity above would fail if the port flattened in its own order."""
    jm, params, state, pm, x = setup
    want, _ = jm.embed(params, state, jnp.asarray(x))
    with torch.no_grad():
        feat = pm.run_nchw(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())["trunk"]
        wrong = identifier.dense_l2norm(
            {"weight": pm.dense1.weight, "bias": pm.dense1.bias},
            feat.reshape(3, 1, 1, -1), torch.float32)
    assert float(np.abs(wrong.numpy() - np.asarray(want)).max()) > 100 * F32_TOL


@pytest.mark.parametrize("front", [0, 2])
def test_embed_folded_bf16_matches_jax(setup, front):
    jm, params, state, pm, x = setup
    jf = jm.fold(params, state)
    want = jax.jit(lambda f, xx: jm.embed_folded(f, xx, compute_dtype=jnp.bfloat16,
                                                 f32_front_blocks=front))(jf, jnp.asarray(x))
    got = pm.embed_folded(pm.fold(), torch.from_numpy(x), compute_dtype=torch.bfloat16,
                          f32_front_blocks=front)
    assert got.dtype == torch.float32
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= BF16_TOL
    f32 = pm.embed_folded(pm.fold(), torch.from_numpy(x), compute_dtype=torch.float32)
    assert float(np.abs(f32.numpy() - pm.embed(torch.from_numpy(x)).numpy()).max()) <= F32_TOL


def test_dense_bf16_rounds_the_product_before_the_bias():
    """The bf16 dense1 is a bf16 product (rounded to bf16) plus the f32
    bias, as the JAX bf16 dot with no preferred type: not the f32 product
    plus the bias rounded once."""
    rng = np.random.default_rng(4)
    feat = rng.normal(size=(4, 1, 1, 256)).astype(np.float32)
    w = rng.normal(size=(8, 256)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32) * 1e-3
    dense = {"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)}
    got = identifier.dense_l2norm(dense, torch.from_numpy(feat), torch.bfloat16)
    prod = (torch.from_numpy(feat).reshape(4, -1).bfloat16()
            @ torch.from_numpy(w).bfloat16().t())
    h = torch.relu(prod.float() + torch.from_numpy(b))
    want = h / torch.sqrt(torch.clamp_min((h * h).sum(-1, keepdim=True), 1e-12))
    assert torch.equal(got, want)
    jm_out = JaxModel._dense_l2norm(
        None, {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)}, jnp.asarray(feat),
        jnp.bfloat16)
    assert float(np.abs(got.numpy() - np.asarray(jm_out)).max()) <= BF16_TOL


def test_embed_quant_trunk_is_bit_exact(setup):
    """int8: JAX-calibrated qparams through the port's walk (kernel A0's
    plain version on every conv, never the block kernel) give the jitted
    JAX trunk bit for bit, and the embedding within the bf16 bound."""
    jm, params, state, pm, x = setup
    jf = jax.device_get(jm.fold(params, state))
    qp = jm.quantize(jf, jnp.asarray(x))
    want_trunk = np.asarray(jax.jit(
        lambda xx: jax_quant.apply_graph_quant(qp, xx, jm.ops)["trunk"])(jnp.asarray(x)))
    want = np.asarray(jax.jit(lambda xx: jm.embed_quant(qp, xx))(jnp.asarray(x)))
    pq = qparams_from_jax({k: v for k, v in qp.items() if k != "dense1"})
    dense = identifier_params_from_jax({"dense1": qp["dense1"]}, {})
    pq["dense1"] = {"weight": dense["dense1.weight"], "bias": dense["dense1.bias"]}
    got_trunk = quant.apply_graph_quant(pq, torch.from_numpy(x), jm.ops)["trunk"]
    np.testing.assert_array_equal(got_trunk.numpy(), want_trunk)
    assert float((got_trunk != 0).float().mean()) > 0.3
    calls = []
    orig = quant.conv_int8, quant.block_int8
    quant.conv_int8 = lambda *a, **k: calls.append("A0") or orig[0](*a, **k)
    quant.block_int8 = lambda *a, **k: calls.append("A") or orig[1](*a, **k)
    try:
        got = pm.embed_quant(pq, torch.from_numpy(x))
    finally:
        quant.conv_int8, quant.block_int8 = orig
    assert calls.count("A0") == 52 and "A" not in calls
    assert float(np.abs(got.numpy() - want).max()) <= BF16_TOL
    # The port's own calibration keeps dense1 as the folded f32 weights.
    own = pm.quantize(pm.fold(), torch.from_numpy(x))
    assert torch.equal(own["dense1"]["weight"], pm.dense1.weight)


def test_training_forward_and_triplet_loss_match_jax(setup):
    jm, params, state, pm, x = setup
    rng = np.random.default_rng(5)
    a, p, n = (rng.uniform(0, 1, (2, S, S, 3)).astype(np.float32) for _ in range(3))
    want, jstate = jm.triplet_forward(params, state, jnp.asarray(a), jnp.asarray(p),
                                      jnp.asarray(n), train=True)
    tp, ts = darknet.split_state_dict(identifier_params_from_jax(params, state))
    got, new_state = pm.triplet_forward(tp, ts, *(torch.from_numpy(v) for v in (a, p, n)))
    assert got.shape == (2, 3 * D)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= F32_TOL
    assert float(FaceIdentifierModel.triplet_loss(got, dim=D)) == pytest.approx(
        float(JaxModel.triplet_loss(want, dim=D)), rel=1e-5)
    want_state = identifier_params_from_jax({}, jax.device_get(jstate))
    for k, w in want_state.items():
        assert float((new_state[k] - w).abs().max()) <= 1e-5 * float(w.abs().max()), k


# ------------------------------------------------------------------ Keras h5

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_identifier_h5_round_trips_across_packages(setup, tmp_path, writer):
    """face_identifier.h5 written by either package reads back in the
    other with the same trunk and dense1 (the (flat, D) Keras kernel)."""
    _, params, state, pm, _ = setup
    path = str(tmp_path / "face_identifier.h5")
    if writer == "port":
        keras_import.save_identifier_keras_h5(pm.state_dict(), path)
        jp, js = jax.device_get(jax_keras.identifier_from_keras_h5(path))
        for k in params:
            for f in params[k]:
                np.testing.assert_array_equal(np.asarray(jp[k][f]), params[k][f])
        for k in state:
            for f in state[k]:
                np.testing.assert_array_equal(np.asarray(js[k][f]), state[k][f])
    else:
        jax_keras.save_identifier_keras_h5(params, state, path)
        sd = keras_import.identifier_from_keras_h5(path)
        want = pm.state_dict()
        assert set(sd) == set(want)
        assert all(torch.equal(sd[k], want[k]) for k in want)


def test_remat_equals_the_plain_training_forward(setup):
    """remat (torch.utils.checkpoint over the residual segments) recomputes
    the same forward: loss, gradients and BN state match the plain run."""
    _, params, state, pm, x = setup
    tp, ts = darknet.split_state_dict(identifier_params_from_jax(params, state))
    runs = []
    for remat in (False, True, 3):
        leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        out, st = pm.triplet_forward(leaves, ts, *(torch.from_numpy(x[i:i + 1]) for i in range(3)),
                                     remat=remat)
        loss = FaceIdentifierModel.triplet_loss(out, dim=D)
        loss.backward()
        runs.append((loss.detach(), {k: v.grad for k, v in leaves.items()}, st))
    for loss, grads, st in runs[1:]:
        assert float(loss) == pytest.approx(float(runs[0][0]), rel=1e-6, abs=1e-7)
        for k, g in runs[0][1].items():
            assert torch.allclose(grads[k], g, rtol=1e-4, atol=1e-7), k
        for k, v in runs[0][2].items():
            assert torch.allclose(st[k], v, rtol=1e-6, atol=1e-7), k
    assert len(darknet.remat_segments(pm.ops)) == 24
