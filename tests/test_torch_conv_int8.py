"""int8 conv + fused epilogue of the port vs the JAX package's jitted program.

The JAX side is models/quant.py's `_conv_int8` followed by the epilogue of
apply_graph_quant (:803-816), jitted as serving runs it: XLA contracts
`acc * w_scale + bias` and `h + skip * skip_s` into fused multiply-adds.
The port's plain twin (what `conv_int8` runs for CPU tensors) must equal it
bit for bit: int32 sums are exact, and each epilogue step rounds at the same
place. The CUDA kernel (csrc/conv_int8.cu) is held against the plain twin in
`test_cuda_*`, which needs a card and skips without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.models import quant as jax_quant
from face_vijnana_yolov3_tpu.models.darknet import LEAKY_ALPHA
from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import (
    GATHER_BAND_BYTES,
    TILE_PIXELS,
    conv_acc_reference,
    conv_int8,
    conv_int8_reference,
    fma_f32,
    launch_config,
    out_size,
    requant_reference,
)

torch.set_num_threads(2)

# (batch, h, w, cin, cout, k, stride, leaky, skip): conv_0's Cin=3, the
# stride-2 stage convs, the stage-1/2 block convs, rectangular inputs, and
# channel counts off the kernel's tiles (Cin not a multiple of 32, Cout of 64).
CASES = [
    (2, 16, 16, 3, 32, 3, 1, True, False),
    (2, 17, 23, 32, 64, 3, 2, True, False),
    (2, 12, 12, 64, 32, 1, 1, True, False),
    (2, 12, 12, 32, 64, 3, 1, True, True),
    (2, 10, 14, 64, 128, 3, 2, True, False),
    (1, 7, 7, 256, 512, 3, 2, True, False),
    (2, 9, 5, 128, 64, 1, 1, False, False),
    (2, 6, 11, 64, 128, 3, 1, False, True),
    (2, 9, 7, 40, 24, 3, 1, True, True),
]


def _case(b, h, w, cin, cout, k, stride, skip, seed):
    rng = np.random.default_rng(seed)
    ho = (h + 2 * (k // 2) - k) // stride + 1
    wo = (w + 2 * (k // 2) - k) // stride + 1
    # Scales in the range calibration gives: |h| has a standard deviation of
    # about 42 * U(0.5, 2) and the output scale spans 60-180 of it, so the
    # requant lands mostly inside +-127 and rounding (not the clip) decides
    # most outputs.
    fan_in = k * k * cin
    args = dict(
        x=rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8),
        w=rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8),
        w_scale=(rng.uniform(0.5, 2.0, cout) / (127 * np.sqrt(fan_in))).astype(np.float32),
        bias=rng.normal(0, 0.2, cout).astype(np.float32),
        inv=(127 / (60 * rng.uniform(1.0, 3.0, cout))).astype(np.float32),
    )
    if skip:
        args["skip"] = rng.integers(-127, 128, (b, ho, wo, cout)).astype(np.int8)
        args["skip_s"] = rng.uniform(0.1, 0.5, cout).astype(np.float32)
    return args


def _jax_conv(a, stride, k, leaky):
    def f(x, w, ws, bias, inv, skip=None, skip_s=None):
        y = jax_quant._conv_int8(x, w, stride, k)
        h = y.astype(jnp.float32) * ws + bias
        if leaky:
            h = jnp.where(h > 0, h, LEAKY_ALPHA * h)
        if skip is not None:
            h = h + skip.astype(jnp.float32) * skip_s
        return jnp.clip(jnp.round(h * inv), -127, 127).astype(jnp.int8)

    keys = ["x", "w", "w_scale", "bias", "inv"] + (["skip", "skip_s"] if "skip" in a else [])
    return np.asarray(jax.jit(f)(*(a[k] for k in keys)))


def _port_args(a):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    t["w"] = t["w"].permute(3, 0, 1, 2).contiguous()  # HWIO -> OHWI
    return t


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_plain_version_matches_jax_jit(case):
    b, h, w, cin, cout, k, stride, leaky, skip = case
    a = _case(b, h, w, cin, cout, k, stride, skip, seed=sum(case[:7]))
    want = _jax_conv(a, stride, k, leaky)
    t = _port_args(a)
    got = conv_int8(t["x"], t["w"], t["w_scale"], t["bias"], t["inv"],
                    stride=stride, leaky=leaky, skip_q=t.get("skip"),
                    skip_s=t.get("skip_s"))
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the case exercises rounding, not only the clip
    assert 0.05 < float(np.mean(np.abs(want) < 127)) and (want != 0).mean() > 0.5


def test_fma_f32_matches_xla_contraction():
    """fma_f32 equals the fused multiply-add XLA emits under jit (the
    unfused product-then-sum differs in about a quarter of these values)."""
    rng = np.random.default_rng(0)
    n = 1 << 18
    acc = rng.integers(-2 ** 20, 2 ** 20, n).astype(np.int32)
    ws = rng.uniform(1e-5, 1e-3, n).astype(np.float32)
    b = rng.normal(0, 1, n).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, w, c: a.astype(jnp.float32) * w + c)(acc, ws, b))
    ta, tw, tb = (torch.from_numpy(v) for v in (acc, ws, b))
    np.testing.assert_array_equal(fma_f32(ta.float(), tw, tb).numpy(), want)
    assert (ta.float() * tw + tb).numpy().tolist() != want.tolist()


def test_fma_f32_rounds_once_at_ties():
    """Values whose float64 sum lands exactly halfway between two floats
    although the exact sum does not: round-to-odd keeps them correct."""
    a = torch.tensor([1.0 + 2.0 ** -23, 1.0 + 2.0 ** -23], dtype=torch.float32)
    b = torch.tensor([1.0 + 2.0 ** -23, -(1.0 + 2.0 ** -23)], dtype=torch.float32)
    c = torch.tensor([2.0 ** -60, -(2.0 ** -60)], dtype=torch.float32)
    got = fma_f32(a, b, c)
    # exact a*b = 1 + 2^-22 + 2^-46; + c moves it off the halfway point
    want = np.float32(1.0 + 2.0 ** -22)
    assert float(got[0]) == want and float(got[1]) == -want


def test_wrapper_routes_cpu_tensors_to_plain_version():
    a = _port_args(_case(1, 6, 6, 32, 32, 3, 1, False, seed=3))
    before = conv_int8.launches
    got = conv_int8(a["x"], a["w"], a["w_scale"], a["bias"], a["inv"], stride=1,
                    leaky=True)
    want = conv_int8_reference(a["x"], a["w"], a["w_scale"], a["bias"], a["inv"],
                               stride=1, leaky=True)
    assert torch.equal(got, want)
    assert conv_int8.launches == before  # only a kernel launch counts


def test_wrapper_refuses_bad_calls():
    a = _port_args(_case(1, 6, 6, 32, 32, 3, 1, False, seed=4))
    meta = {k: v.to("meta") for k, v in a.items()}
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        conv_int8(meta["x"], meta["w"], meta["w_scale"], meta["bias"], meta["inv"],
                  stride=1, leaky=True)
    with pytest.raises(ValueError, match="together"):
        conv_int8(a["x"], a["w"], a["w_scale"], a["bias"], a["inv"], stride=1,
                  leaky=True, skip_q=a["x"])


def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for case in CASES + [(8, 416, 416, 3, 32, 3, 1, True, False)]:
        b, h, w, cin, cout, k, stride, leaky, skip = case
        t = _port_args(_case(b, h, w, cin, cout, k, stride, skip, seed=7))
        want = conv_int8_reference(t["x"], t["w"], t["w_scale"], t["bias"], t["inv"],
                                   stride=stride, leaky=leaky, skip_q=t.get("skip"),
                                   skip_s=t.get("skip_s"))
        c = {k_: v.cuda() for k_, v in t.items()}
        before = conv_int8.launches
        got = conv_int8(c["x"], c["w"], c["w_scale"], c["bias"], c["inv"],
                        stride=stride, leaky=leaky, skip_q=c.get("skip"),
                        skip_s=c.get("skip_s"))
        torch.cuda.synchronize()
        assert conv_int8.launches == before + 1
        assert torch.equal(got.cpu(), want), case


# The conv_int8 shapes of the int8 trunk at 416² (h, w, cin, cout, k, stride),
# blocks on and off, plus rectangles with ragged edges.
TRUNK_SHAPES = [
    (416, 416, 3, 32, 3, 1), (416, 416, 32, 64, 3, 2), (208, 208, 64, 32, 1, 1),
    (208, 208, 32, 64, 3, 1), (208, 208, 64, 128, 3, 2), (104, 104, 128, 64, 1, 1),
    (104, 104, 64, 128, 3, 1), (104, 104, 128, 256, 3, 2), (52, 52, 256, 128, 1, 1),
    (52, 52, 128, 256, 3, 1), (52, 52, 256, 512, 3, 2), (26, 26, 512, 256, 1, 1),
    (26, 26, 256, 512, 3, 1), (26, 26, 512, 1024, 3, 2), (13, 13, 1024, 512, 1, 1),
    (13, 13, 512, 1024, 3, 1), (37, 53, 64, 128, 3, 2), (11, 19, 3, 32, 3, 1),
]


@pytest.mark.parametrize("shape", TRUNK_SHAPES, ids=[str(s) for s in TRUNK_SHAPES])
def test_launch_config_tiles_the_output(shape):
    """The TMA tile is a rectangle of at most 128 output pixels that TMA can
    box (<= 256 elements a side at the stride) and covers the image with no
    fewer tiles than any other rectangle; the gather band fits its budget."""
    h, w, cin, cout, k, stride = shape
    ho, wo = out_size(h, w, k, stride)
    tw, th = launch_config(h, w, cin, k, stride)
    if cin % 32:
        assert tw == 0 and 1 <= th <= ho
        assert ((th - 1) * stride + k) * w * cin <= GATHER_BAND_BYTES
        return
    assert 1 <= tw <= wo and 1 <= th <= ho and tw * th <= TILE_PIXELS
    assert tw * stride <= 256 and th * stride <= 256
    tiles = -(-wo // tw) * -(-ho // th)
    assert (-(-wo // tw) - 1) * tw < wo and (-(-ho // th) - 1) * th < ho
    for w2 in range(1, min(wo, TILE_PIXELS) + 1):
        h2 = min(TILE_PIXELS // w2, ho)
        assert tiles <= -(-wo // w2) * -(-ho // h2)


def _fragment_rows_cols(bn):
    """(row, column, accumulator index) of every accumulator register of two
    warpgroups' m64nN wgmma tiles, in the PTX fragment layout the kernels'
    epilogue (csrc/int8_mma.cuh epilogue_tile) assumes."""
    wg, warp, lane, i = np.meshgrid(np.arange(2), np.arange(4), np.arange(32),
                                    np.arange(bn // 2), indexing="ij")
    g, t = lane // 4, lane % 4
    row = 64 * wg + 16 * warp + g + 8 * ((i >> 1) & 1)
    col = 8 * (i >> 2) + 2 * t + (i & 1)
    return row.ravel(), col.ravel()


def _tma_box(x, b, c0, x0, y0, bkc, tw, th, stride):
    """A tiled TMA box of x (B, H, W, C) at (c0, x0, y0, b), box
    (bkc, tw*stride, th*stride, 1), element strides (1, s, s, 1), zero fill
    out of bounds (negative coordinates included) → (th*tw, bkc) rows."""
    _, hh, ww, _ = x.shape
    ys, xs = y0 + stride * np.arange(th), x0 + stride * np.arange(tw)
    ok = ((ys >= 0) & (ys < hh))[:, None] & ((xs >= 0) & (xs < ww))[None, :]
    box = x[b][np.clip(ys, 0, hh - 1)][:, np.clip(xs, 0, ww - 1), c0:c0 + bkc]
    return (box * ok[..., None]).reshape(th * tw, bkc)


def _emulate_tma(x, wq, stride, tw, th):
    """The int32 sums of csrc/conv_int8.cu's TMA kernel, walked tile by tile
    with its index math: the per-(tap, chunk) boxes, the [Cout][K] weight
    boxes (rows past Cout zero), 128 tile rows of which tw*th are pixels,
    and the epilogue's fragment-to-pixel mapping (each output once)."""
    bsz, _, _, cin = x.shape
    cout, k = wq.shape[0], wq.shape[1]
    pad = k // 2
    ho, wo = out_size(x.shape[1], x.shape[2], k, stride)
    bkc = 128 if cin % 128 == 0 else 64 if cin % 64 == 0 else 32
    bn = 32 if cout <= 32 else 64 if cout <= 64 else 128
    wk = np.zeros((-(-cout // bn) * bn, k * k * cin), np.int64)
    wk[:cout] = wq.reshape(cout, -1)
    rows, cols = _fragment_rows_cols(bn)
    assert np.bincount(rows * bn + cols).tolist() == [1] * (128 * bn)  # a permutation
    acc_out = np.zeros((bsz, ho, wo, cout), np.int64)
    hits = np.zeros(acc_out.shape, np.int64)
    tiles_w, tiles_h = -(-wo // tw), -(-ho // th)
    for blk in range(bsz * tiles_h * tiles_w):
        tx, ty, b = blk % tiles_w, (blk // tiles_w) % tiles_h, blk // (tiles_w * tiles_h)
        for n0 in range(0, cout, bn):
            acc = np.zeros((128, bn), np.int64)
            for kt in range(k * k * cin // bkc):
                tap, c0 = divmod(kt * bkc, cin)
                ky, kx = divmod(tap, k)
                a = np.zeros((128, bkc), np.int64)  # rows past tw*th: junk, dropped
                a[:tw * th] = _tma_box(x, b, c0, tx * tw * stride - pad + kx,
                                       ty * th * stride - pad + ky, bkc, tw, th, stride)
                acc += a @ wk[n0:n0 + bn, tap * cin + c0:tap * cin + c0 + bkc].T
            oy, ox = ty * th + rows // tw, tx * tw + rows % tw
            keep = (rows < tw * th) & (oy < ho) & (ox < wo) & (n0 + cols < cout)
            acc_out[b, oy[keep], ox[keep], n0 + cols[keep]] = acc[rows[keep], cols[keep]]
            hits[b, oy[keep], ox[keep], n0 + cols[keep]] += 1
    assert (hits == 1).all()
    return acc_out


def _emulate_gather(x, wq, stride, rows_per_band):
    """The int32 sums of csrc/conv_int8.cu's gather kernel (conv_0): the
    band as one byte range of NHWC copied from the 16-byte boundary below it,
    the K table (koff, kyx) with K padded to 32, 64-pixel im2col chunks in
    band order, and 32-byte K steps."""
    bsz, hh, ww, cin = x.shape
    cout, k = wq.shape[0], wq.shape[1]
    pad = k // 2
    ho, wo = out_size(hh, ww, k, stride)
    kdim = k * k * cin
    kpad = -(-kdim // 32) * 32
    kk = np.arange(kpad)
    tap, ci = kk // cin, kk % cin
    ky, kx = tap // k, tap % k
    koff = np.where(kk < kdim, (ky * ww + kx) * cin + ci, 0)
    live = kk < kdim
    flat = x.reshape(-1).astype(np.int64)
    wk = np.zeros((cout, kpad), np.int64)
    wk[:, :kdim] = wq.reshape(cout, -1)
    acc_out = np.zeros((bsz, ho, wo, cout), np.int64)
    row_bytes = ww * cin
    for b in range(bsz):
        for oy0 in range(0, ho, rows_per_band):
            rows_out = min(rows_per_band, ho - oy0)
            ylo = max(oy0 * stride - pad, 0)
            yhi = min((oy0 + rows_out - 1) * stride - pad + k, hh)
            start, end = (b * hh + ylo) * row_bytes, (b * hh + yhi) * row_bytes
            a0 = start & ~15
            band = np.zeros(-(-(end - a0) // 16) * 16, np.int64)
            band[:end - a0] = flat[a0:end]
            m_total = rows_out * wo
            for chunk in range(-(-m_total // 64)):
                m = chunk * 64 + np.arange(64)
                m_ok = m < m_total
                oy = oy0 + np.where(m_ok, m // wo, 0)
                ox = np.where(m_ok, m % wo, 0)
                iy = (oy * stride - pad)[:, None] + ky[None]
                ix = (ox * stride - pad)[:, None] + kx[None]
                ok = (m_ok[:, None] & live[None] & (iy >= 0) & (iy < hh)
                      & (ix >= 0) & (ix < ww))
                pbase = (start - a0) + ((oy * stride - pad - ylo) * ww
                                        + ox * stride - pad) * cin
                idx = np.where(ok, pbase[:, None] + koff[None], 0)
                a = np.where(ok, band[idx], 0)
                acc = a @ wk.T
                acc_out[b, oy[m_ok], ox[m_ok]] = acc[m_ok]
    return acc_out


def _walk_case(b, h, w, cin, cout, k, stride, skip, seed):
    t = _port_args(_case(b, h, w, cin, cout, k, stride, skip, seed))
    want = conv_int8_reference(t["x"], t["w"], t["w_scale"], t["bias"], t["inv"],
                               stride=stride, leaky=True, skip_q=t.get("skip"),
                               skip_s=t.get("skip_s"))
    return t, want


def _requant(t, acc):
    return requant_reference(torch.from_numpy(acc), t["w_scale"], t["bias"], t["inv"],
                             leaky=True, skip_q=t.get("skip"), skip_s=t.get("skip_s"))


TMA_WALKS = [
    (2, 9, 11, 64, 96, 3, 2, True),     # stride 2, ragged rectangle, 2 N tiles
    (1, 13, 13, 32, 32, 3, 1, False),   # the 13² tiling, BN 32, BKc 32
    (2, 7, 5, 128, 64, 1, 1, True),     # a 1x1 with skip, BKc 128
    (1, 10, 6, 256, 160, 3, 1, False),  # K chunks per tap, a ragged N tile
]


@pytest.mark.parametrize("case", TMA_WALKS, ids=[str(c) for c in TMA_WALKS])
def test_tma_kernel_walk_matches_the_plain_twin(case):
    """The CUDA kernel cannot run here: its tiles, TMA box coordinates (zero
    fill outside the image, stride 2 as the traversal stride) and epilogue
    mapping, walked in numpy, give the plain twin's sums and output."""
    b, h, w, cin, cout, k, stride, skip = case
    t, want = _walk_case(b, h, w, cin, cout, k, stride, skip, seed=sum(case[:6]))
    tw, th = launch_config(h, w, cin, k, stride)
    acc = _emulate_tma(t["x"].numpy(), t["w"].numpy(), stride, tw, th)
    ref = conv_acc_reference(t["x"], t["w"], stride).numpy()
    np.testing.assert_array_equal(acc, ref)
    assert torch.equal(_requant(t, acc), want)


GATHER_WALKS = [
    (2, 16, 16, 3, 32, 3, 1, False, 5),   # conv_0: K 27 -> one 32-byte step
    (1, 11, 19, 3, 32, 3, 1, True, 4),    # rows of 57 bytes: unaligned bands
    (2, 9, 7, 40, 24, 3, 2, False, 2),    # K 360 in 12 steps, Cout 24 of BN 32
]


@pytest.mark.parametrize("case", GATHER_WALKS, ids=[str(c) for c in GATHER_WALKS])
def test_gather_kernel_walk_matches_the_plain_twin(case):
    """conv_0's loader walked in numpy: 16-byte band copy, K table and
    32-byte im2col rows give the plain twin's sums and output."""
    b, h, w, cin, cout, k, stride, skip, rows = case
    t, want = _walk_case(b, h, w, cin, cout, k, stride, skip, seed=sum(case[:6]))
    acc = _emulate_gather(t["x"].numpy(), t["w"].numpy(), stride, rows)
    np.testing.assert_array_equal(acc, conv_acc_reference(t["x"], t["w"], stride).numpy())
    assert torch.equal(_requant(t, acc), want)
    assert launch_config(416, 416, 3, 3, 1) == (0, 4)
