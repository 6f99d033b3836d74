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
from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import requant_reference
from test_torch_conv_int8 import _fragment_rows_cols
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

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
    assert 1 <= rows <= w and (tiles - 1) * rows < w  # no empty row band
    assert block_mod.block_smem(w, ch, rows) <= block_mod.BLOCK_SMEM_LIMIT
    assert n_split in (1, 2, 4) and (c // n_split) % 128 == 0
    # Y holds the band with its halo and every row phase 2 reads at any tap.
    p = block_mod.y_pixels(rows, w)
    assert p % 8 == 0 and p * 16 < 2 ** 18  # the descriptor's LBO field
    assert p >= (rows + 2) * (w + 2)
    assert p >= -(-rows * (w + 2) // 128) * 128 + 2 * (w + 2) + 2
    # No other fitting (rows, n_split) scores lower in the config's model.
    per_sm = lambda r: max(1, block_mod.SM_SMEM // (block_mod.block_smem(w, ch, r) + 1024))  # noqa: E731
    cost = lambda r, n: (-(-b * -(-w // r) * n // (block_mod.SM_COUNT * per_sm(r)))  # noqa: E731
                         * per_sm(r) * block_mod.block_tiles(w, w, c, ch, r, n))
    best = cost(rows, n_split)
    for r in range(1, w + 1):
        if block_mod.block_smem(w, ch, r) <= block_mod.BLOCK_SMEM_LIMIT:
            assert all(cost(r, n) >= best or r != -(-w // -(-w // r))
                       for n in (1, 2, 4) if (c // n) % 128 == 0)


def _emulate_kernel(x, w1, w2, ws1, b1, inv_mid, ws2, b2, skip_s, inv_out,
                    rows, n_split):
    """csrc/block_int8.cu walked in numpy with its index math, per block:
    phase 1's 128-pixel tiles over the contiguous band rows (junk pixels past
    the band computed and dropped), its requant into Y as a flat byte array
    in the interleaved layout (channel k of pixel q at (k/16)*LBO + 16q +
    k%16, LBO = 16P, zero borders and slack); phase 2's 128-row tiles over
    the padded width, each warpgroup's A operand read through the no-swizzle
    descriptor (start 16*(q0 + ky*(W+2) + kx) + (k0/16)*LBO, rows at 16 bytes,
    K chunks at LBO), the output-channel split, the dropped junk columns and
    the fragment-to-pixel mapping."""
    bsz, h, w, c = x.shape
    ch = w1.shape[0]
    wp = w + 2
    p_y = block_mod.y_pixels(rows, w)
    lbo = 16 * p_y
    xf = x.reshape(-1, c).astype(np.int64)
    w1f = w1.reshape(ch, c).astype(np.int64)
    w2f = w2.reshape(c, 9 * ch).astype(np.int64)
    rr_f, cc_f = _fragment_rows_cols(128)
    out = np.zeros_like(x)
    hits = np.zeros(x.shape, np.int64)
    c_per = c // n_split
    t = torch.from_numpy
    i16 = np.arange(64)[:, None] * 16
    for b in range(bsz):
        for r0 in range(0, h, rows):
            rows_out = min(rows, h - r0)
            rlo, rhi = max(r0 - 1, 0), min(r0 + rows_out + 1, h)
            m1 = (rhi - rlo) * w
            pix0 = (b * h + rlo) * w
            for cy in range(n_split):
                y = np.zeros(ch * p_y, np.int64)
                for mt in range(-(-m1 // 128)):
                    a = np.zeros((128, c), np.int64)
                    src = xf[pix0 + mt * 128:pix0 + mt * 128 + 128]  # zero past the tensor
                    a[:len(src)] = src
                    for nt in range(ch // 128):
                        acc = a @ w1f[nt * 128:nt * 128 + 128].T
                        p = mt * 128 + rr_f
                        keep = p < m1
                        n = nt * 128 + cc_f[keep]
                        q = (rlo - r0 + 1 + p[keep] // w) * wp + p[keep] % w + 1
                        val = requant_reference(t(acc[rr_f[keep], cc_f[keep]]), t(ws1)[n],
                                                t(b1)[n], t(inv_mid)[n], leaky=True)
                        y[(n >> 4) * lbo + 16 * q + (n & 15)] = val.numpy()
                m2 = rows_out * wp
                for mt in range(-(-m2 // 128)):
                    for nt in range(c_per // 128):
                        n0 = cy * c_per + nt * 128
                        acc = np.zeros((128, 128), np.int64)
                        for kt in range(9 * ch // 128):
                            tap, c0 = divmod(kt * 128, ch)
                            ky, kx = divmod(tap, 3)
                            k = c0 + np.arange(128)[None, :]
                            for wg in range(2):
                                start = 16 * (mt * 128 + 64 * wg + ky * wp + kx)
                                a = y[start + (k >> 4) * lbo + i16 + (k & 15)]
                                acc[64 * wg:64 * wg + 64] += (
                                    a @ w2f[n0:n0 + 128, kt * 128:kt * 128 + 128].T)
                        qq = mt * 128 + rr_f
                        yr, yc = qq // wp, qq % wp
                        keep = (qq < m2) & (yc < w)
                        oy, ox = r0 + yr[keep], yc[keep]
                        n = n0 + cc_f[keep]
                        val = requant_reference(
                            t(acc[rr_f[keep], cc_f[keep]]), t(ws2)[n], t(b2)[n],
                            t(inv_out)[n], leaky=True, skip_q=t(x[b, oy, ox, n]),
                            skip_s=t(skip_s)[n])
                        out[b, oy, ox, n] = val.numpy()
                        hits[b, oy, ox, n] += 1
    assert (hits == 1).all()
    return out


@pytest.mark.parametrize("b,h,w,c,ch,rows,n_split", [
    (2, 5, 6, 256, 128, 2, 2),   # bands with a ragged last one, split channels
    (1, 4, 13, 256, 256, 4, 1),  # one band: halo rows outside the image
    (1, 7, 3, 384, 128, 3, 1),   # narrow rows, C of three tiles
    (2, 9, 9, 512, 128, 0, 0),   # the launch_config's own choice
])
def test_kernel_index_math_matches_the_plain_twin(b, h, w, c, ch, rows, n_split):
    """The CUDA kernel cannot run here: its band, Y layout, tap offsets,
    padded-width rows, channel split and epilogue mapping, walked in numpy,
    give the plain twin's output bit for bit."""
    args = _random_block(b, h, w, c, ch, seed=b + h + c)
    if rows == 0:
        rows, n_split = launch_config(b, h, w, c, ch)
    got = _emulate_kernel(*(a.numpy() for a in args), rows, n_split)
    np.testing.assert_array_equal(got, block_int8_reference(*args).numpy())


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
