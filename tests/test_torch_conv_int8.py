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
    conv_int8,
    conv_int8_reference,
    fma_f32,
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
