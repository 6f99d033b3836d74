"""The port's folded forward (BN folded into the convs) vs the JAX package's.

Same numpy weights on both sides: the trunk from the JAX init with every BN's
gamma/beta/mean/var perturbed from a seed (the init's zero gamma would fold
each residual branch to a zero kernel), at 64², the full trunk.

Tolerances:
- fold_graph_params: bit-exact (elementwise IEEE ops in the same order);
- f32 forward: 1e-5 of max |ref| (conv summation order; measured 1.5e-6 on
  the trunk, 2.6e-6 on the head);
- bf16 forward: 2e-2 of max |ref|. Each bf16 conv rounds its output to 8
  significant bits in an order-dependent way, and those roundings compound
  over 52 convs: measured port vs JAX 0.9-1.2 %, and the JAX package's own
  eager and jitted bf16 programs differ by 1.0 % from each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.models import darknet as jax_darknet
from face_vijnana_yolov3_tpu.models.detector import FaceDetectorModel as JaxModel
from face_vijnana_yolov3_tpu_torch.convert import folded_from_jax, params_from_jax
from face_vijnana_yolov3_tpu_torch.models import darknet
from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)

F32_TOL = 1e-5
BF16_TOL = 2e-2


def perturbed_params(model, seed):
    params, state = model.init(jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    rng = np.random.default_rng(seed + 100)
    for k in params:
        if k.startswith("bnorm_"):
            c = params[k]["gamma"].shape[0]
            params[k]["gamma"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            params[k]["beta"] = rng.normal(0, 0.1, c).astype(np.float32)
            state[k]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            state[k]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return params, state


@pytest.fixture(scope="module")
def setup():
    jm = JaxModel(image_size=64)
    params, state = perturbed_params(jm, 0)
    folded = jax.device_get(jm.fold(params, state))
    pm = FaceDetectorModel(image_size=64, device="cpu")
    pm.load_state_dict(params_from_jax(params, state))
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    return jm, folded, pm, x


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def test_fold_is_bit_exact(setup):
    _, folded, pm, _ = setup
    got = pm.fold()
    want = folded_from_jax(folded)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k]["kernel"], want[k]["kernel"]), k
        assert torch.equal(got[k]["bias"], want[k]["bias"]), k


def test_front_end_index_matches_jax():
    ops = darknet.trunk_graph()
    for n in (1, 2, 3, 23):
        assert darknet.front_end_index(ops, n) == jax_darknet.front_end_index(ops, n)
    for bad in (0, 24):
        with pytest.raises(ValueError):
            darknet.front_end_index(ops, bad)


@pytest.mark.parametrize("dtype,front", [("float32", 0), ("bfloat16", 0),
                                         ("bfloat16", 1), ("bfloat16", 2)])
def test_apply_graph_folded_matches_jax(setup, dtype, front):
    jm, folded, pm, x = setup
    fr = darknet.front_end_index(jm.ops, front) if front else 0
    want = jax_darknet.apply_graph_folded(
        folded, x, jm.ops, compute_dtype=getattr(jnp, dtype), f32_front_ops=fr)
    got = darknet.apply_graph_folded(
        pm.fold(), torch.from_numpy(x), jm.ops,
        compute_dtype=getattr(torch, dtype), f32_front_ops=fr)
    assert got["trunk"].dtype == torch.float32
    _close(got["trunk"], want["trunk"], F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype,front", [("float32", 0), ("bfloat16", 0),
                                         ("bfloat16", 2)])
def test_apply_folded_head_matches_jax(setup, dtype, front):
    jm, folded, pm, x = setup
    want = jm.apply_folded(folded, x, compute_dtype=getattr(jnp, dtype),
                           f32_front_blocks=front)
    got = pm.apply_folded(pm.fold(), torch.from_numpy(x),
                          compute_dtype=getattr(torch, dtype), f32_front_blocks=front)
    assert got.shape == (2, 2, 2, 6) and got.dtype == torch.float32
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


def test_folded_f32_matches_the_module_forward(setup):
    """Folding BN changes only the rounding: the folded f32 head against the
    module's own eval-BN forward."""
    _, _, pm, x = setup
    _close(pm.apply_folded(pm.fold(), torch.from_numpy(x),
                           compute_dtype=torch.float32),
           pm(torch.from_numpy(x)), F32_TOL)


def test_exact_f32_restores_the_flags():
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with darknet.exact_f32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
