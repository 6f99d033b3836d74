"""The quantization path's divisions by 127, held to the JAX package on
the CPU.

Four places of the port divide by 127: the "auto" and msegrid calibration
grids (models/quant.py `auto_grid`, `msegrid_grid`) and the training
fake-quant's scales (models/darknet.py `_act_fq`, `_weight_fq`). There
are two f32 results to choose from: the quotient x / 127 (numpy, eager
JAX, torch on the CPU) and the product x * f32(1/127), one ulp off it on
some elements. CUDA computes the product for a tensor divided by a Python
number, so the card and the CPU used to part there. Each site now picks
one form on every device:

- the grids are the product: the JAX package's calibration walks run
  jitted (face_vijnana_yolov3_tpu/models/quant.py:157, :260) and XLA
  compiles their division by the constant into that product, which the
  compiled program shows;
- the fake-quant scales are the quotient (`darknet.div_127`, a division by
  a 0-d tensor on the operand's device): the JAX functions as the JAX
  package's own tests call them (tests/test_qat.py), and the quotient the
  served program's quantize_folded computes, as models/qat.py's `_fq_conv`.

Every comparison here is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.models import darknet as jax_darknet
from face_vijnana_yolov3_tpu.models import quant as jax_quant
from face_vijnana_yolov3_tpu_torch.models import darknet, quant
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

F32_INV_127 = np.float32(1.0) / np.float32(127.0)


def _maxabs_like(rng, n: int) -> np.ndarray:
    """n positive f32 values spread over several decades, like per-channel
    maxabs statistics."""
    return (np.abs(rng.standard_normal(n)) * 10.0 ** rng.uniform(-3, 2, n)).astype(np.float32)


def _nhwc(rng, c: int = 96) -> np.ndarray:
    return (rng.normal(0, 1, (2, 9, 7, c)) * rng.uniform(0.01, 10, c)).astype(np.float32)


def test_the_reciprocal_product_is_not_the_quotient():
    """The fault is real: x * f32(1/127), the card's rule for a tensor
    divided by a Python number, is one ulp off eager JAX's x / 127 on some
    elements, and the jitted JAX division is that product on every one."""
    x = _maxabs_like(np.random.default_rng(0), 4096)
    product = x * F32_INV_127
    eager = np.asarray(jnp.asarray(x) / 127.0)
    jitted = np.asarray(jax.jit(lambda v: v / 127.0)(jnp.asarray(x)))
    moved = product != eager
    assert moved.sum() > 0
    assert np.all(np.abs(product[moved].view(np.int32) - eager[moved].view(np.int32)) == 1)
    np.testing.assert_array_equal(eager, x / np.float32(127.0))
    np.testing.assert_array_equal(jitted, product)


def test_div_127_is_the_f32_quotient():
    """The helper of the fake-quant sites: numpy's f32 quotient bit for
    bit, and not the product wherever the two differ."""
    x = _maxabs_like(np.random.default_rng(1), 4096)
    got = darknet.div_127(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, x / np.float32(127.0))
    assert (got != x * F32_INV_127).sum() > 0
    assert np.float32(quant.INV_127) == F32_INV_127


@pytest.mark.parametrize("percentile", ["auto", "msegrid"])
def test_jax_calibration_walk_multiplies_by_the_reciprocal(monkeypatch, percentile):
    """The JAX package's own calibration walk, compiled as it runs it: its
    program holds the f32 constant 1/127 (0.00787401572), the product
    XLA made of the grid's division by 127."""
    compiled = []
    real_jit = jax.jit

    def recording_jit(fn, *args, **kwargs):
        jitted = real_jit(fn, *args, **kwargs)

        def call(*inputs):
            compiled.append(jitted.lower(*inputs).compile().as_text())
            return jitted(*inputs)
        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    x = np.abs(_nhwc(np.random.default_rng(2), 16))
    jax_quant.calibrate_folded({}, x, [], percentile=percentile)
    assert len(compiled) == 1
    assert f"constant({float(F32_INV_127):.9g})" in compiled[0]


def _jax_auto_grid(cands):
    # face_vijnana_yolov3_tpu/models/quant.py:112, inside the jitted walk
    return jnp.maximum(cands, 1e-8)[:, None, :] / 127.0


def _jax_msegrid_grid(m, ratios):
    # face_vijnana_yolov3_tpu/models/quant.py:230, inside the jitted walk
    return (jnp.maximum(m, 1e-8)[None, :] * ratios[:, None]) / 127.0


def test_auto_grid_equals_the_jitted_jax():
    rng = np.random.default_rng(3)
    cands = np.stack([_maxabs_like(rng, 512) for _ in range(3)])
    cands[:, :4] = 0.0  # the 1e-8 floor
    want = np.asarray(jax.jit(_jax_auto_grid)(jnp.asarray(cands)))[:, 0, :]
    got = quant.auto_grid(torch.from_numpy(cands)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != np.maximum(cands, np.float32(1e-8)) / np.float32(127.0)).sum() > 0


def test_msegrid_grid_equals_the_jitted_jax():
    m = _maxabs_like(np.random.default_rng(4), 512)
    m[:4] = 0.0
    ratios = np.asarray(quant.msegrid_ratios(), np.float32)
    want = np.asarray(jax.jit(_jax_msegrid_grid)(jnp.asarray(m), jnp.asarray(ratios)))
    got = quant.msegrid_grid(torch.from_numpy(m), torch.from_numpy(ratios)).numpy()
    np.testing.assert_array_equal(got, want)
    quotient = (np.maximum(m, np.float32(1e-8))[None, :] * ratios[:, None]) / np.float32(127.0)
    assert (got != quotient).sum() > 0


def test_act_fq_equals_the_jax_function():
    """_act_fq's scale and value equal the JAX function's (called as its
    tests call it); the product form would move some scales."""
    h = _nhwc(np.random.default_rng(5), 512)
    want, want_s = jax_darknet._act_fq(jnp.asarray(h))
    got, got_s = darknet._act_fq(torch.from_numpy(h).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))
    amax = np.maximum(np.abs(h).max(axis=(0, 1, 2)), np.float32(1e-6))
    assert (got_s.numpy() != amax * F32_INV_127).sum() > 0


@pytest.mark.parametrize("with_scales", [False, True])
def test_weight_fq_equals_the_jax_function(with_scales):
    rng = np.random.default_rng(6)
    k = rng.normal(0, 0.1, (3, 3, 256, 64)).astype(np.float32)
    s_in = _maxabs_like(rng, 256) / np.float32(127.0) if with_scales else None
    want = np.asarray(jax_darknet._weight_fq(
        jnp.asarray(k), None if s_in is None else jnp.asarray(s_in)))
    got = darknet._weight_fq(torch.from_numpy(k).permute(3, 2, 0, 1),
                             None if s_in is None else torch.from_numpy(s_in))
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)
