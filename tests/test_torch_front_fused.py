"""The port's fused trunk front (ops/front_fused.py) vs the JAX package's
Pallas `fused_front`, run in interpret mode on the CPU.

Same numpy weights on both sides: the JAX init with every BN's statistics
perturbed from a seed (test_torch_folded.py), folded, and for the JAX side
rearranged by models/s2d.build_s2d_folded; the port reads that same s2d
tree through convert.folded_from_jax and ignores its s2d keys.

Tolerances:
- f32: atol 5e-6 (conv summation order; the bound of
  tests/test_pallas_nms.py::test_pallas_fused_front_matches_stock_interpret);
- bf16: the port and the Pallas kernel sum each conv in another order, so
  an f32 sum that lies next to a bf16 rounding boundary rounds the other
  way: max |diff| at most one bf16 step at the top of the range (2^-7 of
  max |ref|) on at most 0.1 % of the elements (measured 9.2e-5 of them);
- the whole 64² trunk behind the front: 2e-2 of max |ref|, the bf16 bound
  of test_torch_folded.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.models import darknet as jax_darknet
from face_vijnana_yolov3_tpu.models.detector import FaceDetectorModel as JaxModel
from face_vijnana_yolov3_tpu.models.s2d import build_s2d_folded
from face_vijnana_yolov3_tpu.ops import pallas_front
from face_vijnana_yolov3_tpu_torch.convert import folded_from_jax
from face_vijnana_yolov3_tpu_torch.models import darknet
from face_vijnana_yolov3_tpu_torch.ops.front_fused import (
    apply_graph_folded_front,
    front_kernel_weights,
    fused_front,
    fused_front_plain,
)
from test_torch_folded import perturbed_params

torch.set_num_threads(2)

F32_ATOL = 5e-6
BF16_STEP = 2.0 ** -7
BF16_MAX_FRACTION = 1e-3
BF16_TOL = 2e-2


@pytest.fixture(scope="module")
def weights():
    jm = JaxModel(image_size=64)
    params, state = perturbed_params(jm, 0)
    folded_s2d = build_s2d_folded(jm.fold(params, state))
    return jm, folded_s2d, folded_from_jax(folded_s2d)


def _x(size, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (2, size, size, 3)).astype(np.float32)


def _bf16_close(got, want):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = np.abs(got - want)
    top = float(np.abs(want).max())
    assert float(diff.max()) <= BF16_STEP * top, (float(diff.max()), top)
    assert float((diff > 0).mean()) <= BF16_MAX_FRACTION, float((diff > 0).mean())


@pytest.mark.parametrize("size", [64, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_fused_front(weights, size, dtype):
    _, folded_s2d, folded = weights
    x = _x(size)
    want = pallas_front.fused_front(x, folded_s2d, compute_dtype=getattr(jnp, dtype),
                                    interpret=True)
    got = fused_front_plain(torch.from_numpy(x), folded,
                            compute_dtype=getattr(torch, dtype))
    assert got.shape == (2, size // 2, size // 2, 64)
    assert got.dtype == getattr(torch, dtype) and got.is_contiguous()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_ATOL)
    else:
        _bf16_close(got, want)


def test_plain_f32_matches_the_stock_front(weights):
    """In f32 the fused front is the stock folded conv_0/conv_1 pair (the
    claim of the Pallas kernel's own test)."""
    jm, _, folded = weights
    x = _x(64, seed=2)
    stock = darknet.apply_graph_folded(folded, torch.from_numpy(x),
                                       jm.ops[:2] + [("output", "t")],
                                       compute_dtype=torch.float32)["t"]
    got = fused_front_plain(torch.from_numpy(x), folded, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), stock.numpy(), rtol=0, atol=F32_ATOL)


def test_apply_graph_folded_front_matches_jax(weights):
    jm, folded_s2d, folded = weights
    x = _x(64, seed=3)
    want = pallas_front.apply_graph_folded_front(
        folded_s2d, x, jm.ops, compute_dtype=jnp.bfloat16, interpret=True)["trunk"]
    got = apply_graph_folded_front(folded, torch.from_numpy(x), jm.ops,
                                   compute_dtype=torch.bfloat16)["trunk"]
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 2, 2, 1024)
    assert np.isfinite(got.numpy()).all()
    err = float(np.abs(got.numpy() - want).max())
    assert err <= BF16_TOL * float(np.abs(want).max()), err
    # The same walk as the JAX package's stock path from op 2 on.
    stock = jax_darknet.apply_graph_folded(
        folded_s2d, jnp.asarray(fused_front_plain(torch.from_numpy(x), folded).float()),
        jm.ops[2:], compute_dtype=jnp.bfloat16)["trunk"]
    err = float(np.abs(got.numpy() - np.asarray(stock)).max())
    assert err <= BF16_TOL * float(np.abs(np.asarray(stock)).max()), err


def test_apply_graph_folded_front_needs_the_stock_opening(weights):
    jm, _, folded = weights
    with pytest.raises(AssertionError):
        apply_graph_folded_front(folded, torch.zeros(1, 64, 64, 3), jm.ops[1:])


def test_cpu_tensor_runs_the_plain_twin(weights):
    _, _, folded = weights
    x = torch.from_numpy(_x(64, seed=4))
    before = fused_front.launches
    got = fused_front(x, folded)
    assert fused_front.launches == before
    assert torch.equal(got, fused_front_plain(x, folded))


@pytest.mark.parametrize("shape", [(1, 64, 48, 3), (1, 63, 63, 3), (1, 64, 64, 4)])
def test_non_square_odd_or_wrong_channels_are_refused(weights, shape):
    with pytest.raises(AssertionError):
        fused_front(torch.zeros(shape), weights[2])


def test_wrong_kernel_shapes_are_refused(weights):
    folded = dict(weights[2])
    folded["conv_1"] = {"kernel": torch.zeros(64, 32, 1, 1), "bias": torch.zeros(64)}
    with pytest.raises(ValueError, match="conv_1"):
        fused_front(torch.zeros(1, 64, 64, 3), folded)


def _emulate_kernel(x, w0, b0, w1, b1, tr=8, tc=16):
    """The tile walk of csrc/front_fused.cu in numpy, with its index math:
    the bf16 input patch from rows 2*p0-2 and columns 2*q0-2 (zeros off the
    image), conv_0 as patch gathers at `patch_offset(k)` against w0's
    (dy, dx, cin) K order, the zero row/column -1, bf16 rounding, then
    conv_1 from the tile at (2p + dy, 2q + dx) against w1."""
    def bf16(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            torch.bfloat16).float().numpy()

    def leaky(a):
        return np.where(a > 0, a, np.float32(0.1) * a)

    b, s = x.shape[0], x.shape[1]
    gs = s // 2
    yr, yc, xr, xc = 2 * tr + 1, 2 * tc + 1, 2 * tr + 3, 2 * tc + 3
    k = np.arange(32)
    koff = np.where(k < 27, ((k // 9) * xc + (k // 3) % 3) * 3 + k % 3, -1)
    m = np.arange(yr * yc)
    base = ((m // yc) * xc + m % yc) * 3
    w0f, w1f = w0.float().numpy(), w1.float().numpy()
    out = np.zeros((b, gs, gs, 64), np.float32)
    for n in range(b):
        for p0 in range(0, gs, tr):
            for q0 in range(0, gs, tc):
                patch = np.zeros((xr, xc, 3), np.float32)
                r0, c0 = 2 * p0 - 2, 2 * q0 - 2
                rs, cs = max(r0, 0), max(c0, 0)
                re, ce = min(r0 + xr, s), min(c0 + xc, s)
                patch[rs - r0:re - r0, cs - c0:ce - c0] = x[n, rs:re, cs:ce]
                flat = bf16(patch).ravel()
                a = flat[base[:, None] + np.where(koff < 0, 0, koff)[None, :]]
                a[:, koff < 0] = 0.0
                y = leaky(a @ w0f.T + b0)
                y = y.reshape(yr, yc, 32)
                if p0 == 0:
                    y[0] = 0.0
                if q0 == 0:
                    y[:, 0] = 0.0
                y = bf16(y)
                for p in range(min(tr, gs - p0)):
                    qn = min(tc, gs - q0)
                    taps = [y[2 * p + dy, dx:dx + 2 * qn:2] for dy in range(3)
                            for dx in range(3)]
                    a1 = np.concatenate(taps, axis=1)  # (qn, 288), (dy, dx, cin)
                    out[n, p0 + p, q0:q0 + qn] = bf16(leaky(a1 @ w1f.T + b1))
    return out


@pytest.mark.parametrize("size", [64, 36])
def test_kernel_index_math_matches_the_plain_twin(weights, size):
    """The CUDA kernel cannot run here: its tiling, patch offsets, weight
    layout (front_kernel_weights) and zero padding, walked in numpy, must
    give the plain twin's result (36²: ragged tiles on both axes). Same
    bf16 tolerance: the sums run in another order."""
    _, _, folded = weights
    x = _x(size, seed=5)
    w0, b0, w1, b1 = front_kernel_weights(folded)
    assert w0.shape == (32, 32) and w1.shape == (64, 288)
    assert not w0[:, 27:].any()
    got = _emulate_kernel(x, w0, b0.numpy(), w1, b1.numpy())
    want = fused_front_plain(torch.from_numpy(x), folded)
    _bf16_close(torch.from_numpy(got), want.float().numpy())


def test_cuda_fused_front_matches_plain(weights):
    """On the card: the kernel against its plain twin at 64² and 416² (the
    bf16 tolerance above), and the launch counter moves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (csrc/front_fused.cu)")
    folded = {k: {n: t.cuda() for n, t in v.items()} for k, v in weights[2].items()
              if k in ("conv_0", "conv_1")}
    for size in (64, 416):
        x = torch.from_numpy(_x(size, seed=6)).cuda()
        before = fused_front.launches
        got = fused_front(x, folded)
        want = fused_front_plain(x, folded)
        torch.cuda.synchronize()
        assert fused_front.launches == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        _bf16_close(got.cpu(), want.float().cpu().numpy())
