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


def _x(size, seed=1, b=2):
    return np.random.default_rng(seed).uniform(0, 1, (b, size, size, 3)).astype(np.float32)


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


def _emulate_kernel(x, w0, b0, w1, b1):
    """csrc/front_fused.cu in numpy, with its index math. Per 8 x 16 tile
    (p0, q0) of image n: the 19 x 36-pixel f32 patch from rows 2*p0-2 and
    columns 2*q0-2, zeros off the image, taken as the kernel takes it (where
    S % 4 == 0 the 116-float TMA box of the (B, S, 3S) tensor map at float
    column 6*q0-12, pixel c at float 3c + 6, else pixel by pixel). Then each
    warpgroup wg on its own: patch rows 8 wg .. 8 wg + 10 as bf16 4-channel
    pixels Xb; conv_0 over its 9 x 33 positions m = 33 r + j in 5 chunks of
    64 (clamped at 296), A row Xb[r + dy, j .. j + 3] (K = 16 dy + 4 dx +
    cin), B from w0 staged as W0s[k / 8][n][k % 8] read at 2 planes a k16
    step (the wgmma descriptor); the zero row/column -1, bf16 rounding into
    its own Y split by column parity, Y[r][j & 1][cg][j >> 1][8]; conv_1 as
    18 k16 steps, A rows from Y at row 2 wq + dy, parity dx & 1, u = q +
    (dx >> 1), channel groups 2 half, 2 half + 1 (the ldmatrix addresses), B
    from W1s[k / 8][n][k % 8]; output rows p0 + 4 wg + wq, masked to the
    image."""
    def bf16(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            torch.bfloat16).float().numpy()

    def leaky(a):
        return np.where(a > 0, a, np.float32(0.1) * a)

    b, s = x.shape[0], x.shape[1]
    gs = s // 2
    w0s = w0.float().numpy().reshape(32, 6, 8).transpose(1, 0, 2)  # W0s planes
    w1s = w1.float().numpy().reshape(64, 36, 8).transpose(1, 0, 2)  # W1s planes
    w0b = np.concatenate([w0s[2 * dy:2 * dy + 2].transpose(1, 0, 2).reshape(32, 16)
                          for dy in range(3)], axis=1)  # (32, 48): B of steps 0..2
    m = np.minimum(np.arange(320), 296)
    r_m, j_m = m // 33, m % 33
    out = np.zeros((b, gs, gs, 64), np.float32)
    xflat = x.reshape(b, s, 3 * s)
    wq, qq = np.arange(4)[:, None], np.arange(16)[None, :]
    for n in range(b):
        for p0 in range(0, gs, 8):
            for q0 in range(0, gs, 16):
                r0 = 2 * p0 - 2
                rs, re = max(r0, 0), min(r0 + 19, s)
                if s % 4 == 0:  # the TMA box, zero-filled out of bounds
                    f0 = 6 * q0 - 12
                    fs, fe = max(f0, 0), min(f0 + 116, 3 * s)
                    patch = np.zeros((19, 116), np.float32)
                    patch[rs - r0:re - r0, fs - f0:fe - f0] = xflat[n, rs:re, fs:fe]
                    patch = patch[:, 6:114].reshape(19, 36, 3)
                else:
                    c0 = 2 * q0 - 2
                    cs, ce = max(c0, 0), min(c0 + 36, s)
                    patch = np.zeros((19, 36, 3), np.float32)
                    patch[rs - r0:re - r0, cs - c0:ce - c0] = x[n, rs:re, cs:ce]
                for wg in range(2):
                    xb = np.zeros((11, 36, 4), np.float32)
                    xb[..., :3] = bf16(patch[8 * wg:8 * wg + 11])
                    a0 = np.concatenate(
                        [xb[r_m[:, None] + dy, j_m[:, None] + np.arange(4)].reshape(320, 16)
                         for dy in range(3)], axis=1)
                    y = leaky(a0 @ w0b.T + b0)[:297]
                    pad = (((p0 == 0) & (wg == 0)) & (r_m[:297] == 0)) | (
                        (q0 == 0) & (j_m[:297] == 0))
                    y[pad] = 0.0
                    ys = np.zeros((9, 2, 4, 17, 8), np.float32)
                    ys[r_m[:297], j_m[:297] & 1, :, j_m[:297] >> 1] = bf16(y).reshape(297, 4, 8)
                    acc = np.zeros((4, 16, 64), np.float32)
                    for dy in range(3):
                        for dx in range(3):
                            for half in range(2):
                                step = 6 * dy + 2 * dx + half
                                a1 = ys[(2 * wq + dy)[..., None], dx & 1,
                                        2 * half + np.arange(2)[None, None, :],
                                        (qq + (dx >> 1))[..., None]].reshape(4, 16, 16)
                                bm = w1s[2 * step:2 * step + 2].transpose(1, 0, 2).reshape(64, 16)
                                acc += a1 @ bm.T
                    z = bf16(leaky(acc + b1))
                    pr = p0 + 4 * wg
                    pn, qn = min(4, gs - pr), min(16, gs - q0)
                    if pn > 0:
                        out[n, pr:pr + pn, q0:q0 + qn] = z[:pn, :qn]
    return out


@pytest.mark.parametrize("size", [64, 36, 50])
def test_kernel_index_math_matches_the_plain_twin(weights, size):
    """The CUDA kernel cannot run here: its tiling, TMA box and the second
    loader (50 % 4 == 2), patch layout, K orders, weight layouts
    (front_kernel_weights) and zero padding, walked in numpy, must give the
    plain twin's result (36², 50²: ragged tiles on both axes). Same bf16
    tolerance: the sums run in another order."""
    _, _, folded = weights
    x = _x(size, seed=5)
    w0, b0, w1, b1 = front_kernel_weights(folded)
    assert w0.shape == (32, 48) and w1.shape == (64, 288)
    w0r = w0.float().reshape(32, 3, 4, 4)
    assert not w0r[:, :, 3].any() and not w0r[:, :, :, 3].any()
    got = _emulate_kernel(x, w0, b0.numpy(), w1, b1.numpy())
    want = fused_front_plain(torch.from_numpy(x), folded)
    _bf16_close(torch.from_numpy(got), want.float().numpy())


def test_cuda_fused_front_matches_plain(weights):
    """On the card: the kernel against its plain twin (the bf16 tolerance
    above) at 64², at 416² with b = 1 (fewer tiles than SMs), 8 and 32 (many
    tiles a persistent block), 100² (ragged tiles) and 98² (S % 4 == 2: the
    loader without TMA), and the launch counter moves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (csrc/front_fused.cu)")
    folded = {k: {n: t.cuda() for n, t in v.items()} for k, v in weights[2].items()
              if k in ("conv_0", "conv_1")}
    for b, size in ((2, 64), (1, 416), (8, 416), (32, 416), (3, 100), (2, 98)):
        x = torch.from_numpy(_x(size, seed=6, b=b)).cuda()
        before = fused_front.launches
        got = fused_front(x, folded)
        want = fused_front_plain(x, folded)
        torch.cuda.synchronize()
        assert fused_front.launches == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        _bf16_close(got.cpu(), want.float().cpu().numpy())
