"""The fused int8 residual block of the port (ops/block_int8.py) vs the JAX
package's Pallas kernel (ops/pallas_block.py, run in interpret mode as
tests/test_pallas_block.py runs it on the CPU).

The contract is bit-exactness, as in the JAX package: the block equals the
stock int8 walk (two int8 convs with fused epilogues) and the Pallas kernel
on every eligible trunk shape, chained, on rectangular inputs, and
ineligible stage-1/2 blocks fall through to the stock convs. The CUDA kernel
(csrc/block_int8.cu) is held against the plain version in `test_cuda_*`,
which needs a card and skips without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.models import quant as jax_quant
from face_vijnana_yolov3_tpu.ops.pallas_block import (
    block_eligible as jax_block_eligible,
)
from face_vijnana_yolov3_tpu.ops.pallas_block import fused_block_int8
from face_vijnana_yolov3_tpu_torch.convert import qparams_from_jax
from face_vijnana_yolov3_tpu_torch.models import quant
from face_vijnana_yolov3_tpu_torch.ops import block_int8 as block_mod
from face_vijnana_yolov3_tpu_torch.ops.block_int8 import (
    block_eligible,
    block_int8,
    block_int8_reference,
    launch_config,
)

torch.set_num_threads(2)

# The three eligible trunk stages (C, Ch) and the widths the main path gives
# them at 416²: stage 3 52², stage 4 26², stage 5 13².
STAGES = [(256, 128, 52), (512, 256, 26), (1024, 512, 13)]


def _block_graph(rng, n_blocks, c, ch):
    """tests/test_pallas_block.py's graph: n chained residual blocks."""
    ops, folded, idx = [], {}, 0

    def add_conv(out_c, k, in_c):
        nonlocal idx
        ops.append(("conv", idx, out_c, k, 1, True, True))
        folded[f"conv_{idx}"] = {
            "kernel": rng.normal(0, 0.06, (k, k, in_c, out_c)).astype(np.float32),
            "bias": rng.normal(0, 0.1, (out_c,)).astype(np.float32)}
        idx += 1

    for _ in range(n_blocks):
        ops.append(("save", "skip"))
        add_conv(ch, 1, c)
        add_conv(c, 3, ch)
        ops.append(("add", "skip"))
    ops.append(("output", "trunk"))
    return ops, folded


def _check_graph(seed, n_blocks, c, ch, shape):
    rng = np.random.default_rng(seed)
    ops, folded = _block_graph(rng, n_blocks, c, ch)
    x = rng.normal(0, 1, (*shape, c)).astype(np.float32)
    qp = jax_quant.quantize_folded(folded, x, ops)
    want = np.asarray(jax.jit(lambda xx: jax_quant.apply_graph_quant(
        qp, xx, ops, pallas_blocks=True, pallas_interpret=True)["trunk"])(x))
    stock = np.asarray(jax.jit(
        lambda xx: jax_quant.apply_graph_quant(qp, xx, ops)["trunk"])(x))
    np.testing.assert_array_equal(want, stock)
    pqp = qparams_from_jax(qp)
    for fused in (True, False):
        got = quant.apply_graph_quant(pqp, torch.from_numpy(x), ops,
                                      fused_blocks=fused)["trunk"]
        np.testing.assert_array_equal(got.numpy(), want)
    q = np.round(want / qp["act_scales"][-1].astype(np.float32))
    assert (q != 0).mean() > 0.5 and (np.abs(q) < 127).mean() > 0.9
    return ops


@pytest.mark.parametrize("c,ch,h", [(256, 128, 6), (512, 256, 5), (1024, 512, 4),
                                    (384, 128, 5)])
def test_block_bit_exact(c, ch, h):
    _check_graph(c, 1, c, ch, (2, h, h))


def test_chained_blocks_bit_exact():
    """Two consecutive blocks: the first's int8 output feeds the second."""
    _check_graph(7, 2, 256, 128, (2, 6, 6))


@pytest.mark.parametrize("shape", [(2, 4, 7), (1, 9, 3)])
def test_rectangular_spatial(shape):
    """H != W exercises the row and column borders independently."""
    _check_graph(3, 1, 256, 128, shape)


def test_ineligible_blocks_fall_through():
    """A stage-2 block (128/64) with fused blocks on runs the stock convs."""
    before = block_int8.launches
    ops = _check_graph(11, 1, 128, 64, (2, 6, 6))
    assert not quant._block_match(ops, 0, 128)
    assert block_int8.launches == before


def test_eligibility_matches_jax():
    for c in (32, 64, 128, 256, 384, 512, 1024):
        for ch in (16, 32, 64, 128, 256, 512):
            assert block_eligible(c, ch) == jax_block_eligible(c, ch)


@pytest.mark.parametrize("c,ch,h", [(256, 128, 5), (512, 256, 3)])
def test_plain_version_matches_the_pallas_kernel(c, ch, h):
    """block_int8 on raw int8 operands against fused_block_int8 itself: the
    weight layouts (port OHWI, JAX (C, Ch) and HWIO taps) line up."""
    rng = np.random.default_rng(c + h)
    x = rng.integers(-127, 128, (2, h, h + 1, c)).astype(np.int8)
    w1 = rng.integers(-127, 128, (c, ch)).astype(np.int8)
    w2 = rng.integers(-127, 128, (3, 3, ch, c)).astype(np.int8)
    ws1 = (rng.uniform(0.5, 2, ch) / (127 * np.sqrt(c))).astype(np.float32)
    ws2 = (rng.uniform(0.5, 2, c) / (127 * np.sqrt(9 * ch))).astype(np.float32)
    b1 = rng.normal(0, 0.2, ch).astype(np.float32)
    b2 = rng.normal(0, 0.2, c).astype(np.float32)
    inv_mid = (127 / (60 * rng.uniform(1, 3, ch))).astype(np.float32)
    inv_out = (127 / (60 * rng.uniform(1, 3, c))).astype(np.float32)
    skip_s = rng.uniform(0.1, 0.5, c).astype(np.float32)
    want = np.asarray(fused_block_int8(
        x, w1, w2, ws1, b1, inv_mid, ws2, b2, skip_s, inv_out,
        height=h, width=h + 1, interpret=True))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    w1_p = t(w1.T.reshape(ch, 1, 1, c))
    w2_p = t(w2.transpose(3, 0, 1, 2))
    args = (t(x), w1_p, w2_p, t(ws1), t(b1), t(inv_mid), t(ws2), t(b2),
            t(skip_s), t(inv_out))
    before = block_int8.launches
    got = block_int8(*args)
    assert block_int8.launches == before  # the CPU runs the plain version
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(block_int8_reference(*args).numpy(), want)
    assert (np.abs(want) < 127).mean() > 0.5


@pytest.mark.parametrize("b", [1, 2, 4, 8, 32, 128])
@pytest.mark.parametrize("c,ch,w", STAGES + [(256, 128, 20), (512, 256, 7)])
def test_launch_config_covers_the_image(b, c, ch, w):
    rows, n_split = launch_config(b, w, w, c, ch)
    tiles = -(-w // rows)
    assert 1 <= rows <= w and (tiles - 1) * rows < w  # no empty row tile
    assert (rows + 2) * (w + 2) * (ch + 16) <= block_mod.Y_BYTES_CAP
    assert n_split in (1, 2, 4) and (c // n_split) % 128 == 0
    if n_split > 1:  # split only while the launch is short of blocks
        assert tiles * b * n_split // 2 < block_mod.TARGET_BLOCKS


def test_wrapper_refuses_bad_calls():
    z8 = lambda *s: torch.zeros(s, dtype=torch.int8, device="meta")  # noqa: E731
    zf = lambda n: torch.zeros(n, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        block_int8(z8(1, 4, 4, 256), z8(128, 1, 1, 256), z8(256, 3, 3, 128),
                   zf(128), zf(128), zf(128), zf(256), zf(256), zf(256), zf(256))
    with pytest.raises(ValueError, match="multiples of 128"):
        block_int8(z8(1, 4, 4, 128), z8(64, 1, 1, 128), z8(128, 3, 3, 64),
                   zf(64), zf(64), zf(64), zf(128), zf(128), zf(128), zf(128))


def _random_block(b, h, w, c, ch, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (t(rng.integers(-127, 128, (b, h, w, c)).astype(np.int8)),
            t(rng.integers(-127, 128, (ch, 1, 1, c)).astype(np.int8)),
            t(rng.integers(-127, 128, (c, 3, 3, ch)).astype(np.int8)),
            t((rng.uniform(0.5, 2, ch) / (127 * np.sqrt(c))).astype(np.float32)),
            t(rng.normal(0, 0.2, ch).astype(np.float32)),
            t((127 / (60 * rng.uniform(1, 3, ch))).astype(np.float32)),
            t((rng.uniform(0.5, 2, c) / (127 * np.sqrt(9 * ch))).astype(np.float32)),
            t(rng.normal(0, 0.2, c).astype(np.float32)),
            t(rng.uniform(0.1, 0.5, c).astype(np.float32)),
            t((127 / (60 * rng.uniform(1, 3, c))).astype(np.float32)))


def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for b, (c, ch, h) in [(2, s) for s in STAGES] + [(3, (256, 128, 11)),
                                                     (2, (384, 128, 7))]:
        w = {11: 19, 7: 5}.get(h, h)
        args = _random_block(b, h, w, c, ch, seed=c + b)
        want = block_int8_reference(*args)
        before = block_int8.launches
        got = block_int8(*(a.cuda() for a in args))
        torch.cuda.synchronize()
        assert block_int8.launches == before + 1
        assert torch.equal(got.cpu(), want), (b, h, w, c, ch)
