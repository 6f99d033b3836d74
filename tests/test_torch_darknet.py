"""Darknet trunk, detector, converter and weight reader: PyTorch port vs JAX.

Both packages get the same numpy weights (the port through
`convert.params_from_jax`) and the same numpy inputs; JAX runs on the CPU.
Trunk tolerance: rtol 1e-5, atol 1e-5 — the two frameworks sum each conv in
a different order (measured maximum |diff| on these cases is printed with
`-s`). Graph lists, inits, conversions and the .weights reader are exact.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.core.weights import (
    load_darknet_weights as jax_load_weights,
)
from face_vijnana_yolov3_tpu.models import darknet as jdn
from face_vijnana_yolov3_tpu.models.detector import FaceDetectorModel as JaxDetector
from face_vijnana_yolov3_tpu_torch.convert import params_from_jax, params_to_jax
from face_vijnana_yolov3_tpu_torch.core.weights import load_darknet_weights
from face_vijnana_yolov3_tpu_torch.models import darknet
from face_vijnana_yolov3_tpu_torch.models.detector import (
    FaceDetectorModel,
    init_head_params,
)
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)

RTOL = ATOL = 1e-5  # conv summation order differs; see the module docstring


def _stage2_ops():
    """Trunk ops through stage 2 (conv_0..conv_10 and three residual adds)."""
    ops = darknet.trunk_graph()
    end = max(i for i, op in enumerate(ops) if op[:2] == ("conv", 10)) + 2
    assert ops[end - 1][0] == "add"
    return ops[:end] + [("output", "trunk")]


def _routes_ops():
    """A small graph with every op kind the YOLOv3 graph uses."""
    c = darknet._conv
    return [c(0, 8), ("mark", "a"), c(1, 16, stride=2), ("save", "s"),
            c(2, 8, k=1), c(3, 16), ("add", "s"), ("mark", "b"), c(4, 8, k=1),
            ("upsample",), ("concat", "a"), c(5, 5, k=1, bn=False, leaky=False),
            ("output", "y"), ("restore", "b"), ("output", "z")]


def _seed_of(key) -> int:
    """The numpy seed the JAX init derives from a key (darknet.py:155)."""
    return int(np.asarray(jax.random.key_data(key)).ravel()[-1]) & 0x7FFFFFFF


def _random_tree(ops, seed):
    """Weights with live BN statistics (the seeded init zeroes residual gammas).

    Residual-ending convs get small gammas, as trained darknet weights have,
    so 23 stacked adds do not blow the activations up.
    """
    rng = np.random.default_rng(seed)
    params, state = darknet.init_graph_params(ops, seed)
    residual_end = {f"bnorm_{ops[i - 1][1]}" for i, op in enumerate(ops)
                    if op[0] == "add"}
    for name in params:
        if name.startswith("bnorm_"):
            c = params[name]["gamma"].shape[0]
            lo, hi = (0.05, 0.2) if name in residual_end else (0.5, 1.5)
            params[name] = {
                "gamma": rng.uniform(lo, hi, c).astype(np.float32),
                "beta": rng.normal(0, 0.1, c).astype(np.float32),
            }
            state[name] = {
                "mean": rng.normal(0, 0.1, c).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, c).astype(np.float32),
            }
        elif "bias" in params[name]:
            params[name]["bias"] = rng.normal(0, 0.1, params[name]["bias"].shape
                                              ).astype(np.float32)
    return params, state


def _port(ops, params, state):
    m = darknet.Darknet(ops)
    m.load_state_dict(params_from_jax(params, state))
    return m


def test_graph_lists_equal_jax():
    assert darknet.trunk_graph() == jdn.trunk_graph()
    assert darknet.yolov3_graph() == jdn.yolov3_graph()
    for ops in (darknet.trunk_graph(), darknet.yolov3_graph(), _routes_ops()):
        assert darknet.conv_layout(ops) == jdn.conv_layout(ops)


@pytest.mark.parametrize("use_key", [True, False])
def test_init_graph_params_equals_jax(use_key):
    ops = _stage2_ops()
    key = jax.random.PRNGKey(7) if use_key else None
    want_p, want_s = jdn.init_graph_params(ops, key)
    got_p, got_s = darknet.init_graph_params(ops, _seed_of(key) if use_key else None)
    assert jax.tree_util.tree_structure(got_p) == jax.tree_util.tree_structure(want_p)
    for a, b in zip(jax.tree_util.tree_leaves((got_p, got_s)),
                    jax.tree_util.tree_leaves((want_p, want_s))):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_head_init_equals_jax():
    key = jax.random.PRNGKey(3)
    want, _ = JaxDetector().init(key)
    _, head_key = jax.random.split(key)
    got = init_head_params(_seed_of(head_key))
    np.testing.assert_array_equal(got["kernel"], want["head"]["kernel"])
    np.testing.assert_array_equal(got["bias"], want["head"]["bias"])


@pytest.mark.parametrize("size", [32, 64])
def test_trunk_through_stage2_matches_jax(size):
    ops = _stage2_ops()
    params, state = _random_tree(ops, 11)
    x = np.random.default_rng(size).uniform(size=(2, size, size, 3)).astype(np.float32)
    want, _ = jdn.apply_graph(params, state, jnp.asarray(x), ops, train=False)
    got = _port(ops, params, state)(torch.from_numpy(x))
    diff = np.abs(got["trunk"].numpy() - np.asarray(want["trunk"])).max()
    print(f"stage-2 trunk at {size}px: max |diff| {diff:.3g}")
    np.testing.assert_allclose(got["trunk"].numpy(), np.asarray(want["trunk"]),
                               rtol=RTOL, atol=ATOL)


def test_route_ops_match_jax():
    """mark/save/add/upsample/concat/restore and a bias conv, as in YOLOv3."""
    ops = _routes_ops()
    params, state = _random_tree(ops, 12)
    x = np.random.default_rng(0).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    want, _ = jdn.apply_graph(params, state, jnp.asarray(x), ops, train=False)
    got = _port(ops, params, state)(torch.from_numpy(x))
    assert sorted(got) == sorted(want) == ["y", "z"]
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL)


def test_params_roundtrip_is_identity():
    ops = _routes_ops()
    params, state = _random_tree(ops, 13)
    back_p, back_s = params_to_jax(_port(ops, params, state))
    assert jax.tree_util.tree_structure((back_p, back_s)) == \
        jax.tree_util.tree_structure((params, state))
    for a, b in zip(jax.tree_util.tree_leaves((back_p, back_s)),
                    jax.tree_util.tree_leaves((params, state))):
        np.testing.assert_array_equal(a, b)


def _write_weights(path, ops, seed, major=0, minor=2):
    """A darknet .weights file for `ops`: header + seeded floats."""
    n = 0
    for _idx, in_c, out_c, k, _s, bn in darknet.conv_layout(ops):
        n += (4 if bn else 1) * out_c + out_c * in_c * k * k
    data = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    with open(path, "wb") as f:
        f.write(struct.pack("iii", major, minor, 0))
        f.write(b"\0" * (8 if major * 10 + minor >= 2 else 4))
        f.write(data.tobytes())
    return n


def _check_weights_equal(path, ops):
    jp, js = jax_load_weights(str(path), ops)
    sd = load_darknet_weights(str(path), ops)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           jax.tree_util.tree_map(np.asarray, js))
    assert sorted(sd) == sorted(want)
    for k in sd:
        np.testing.assert_array_equal(sd[k], want[k].numpy())


@pytest.mark.parametrize("major,minor", [(0, 2), (0, 1)])
def test_darknet_weights_reader_matches_jax(tmp_path, major, minor):
    ops = _routes_ops()
    _write_weights(tmp_path / "w.weights", ops, 5, major, minor)
    _check_weights_equal(tmp_path / "w.weights", ops)


def test_darknet_weights_reader_raises_when_exhausted(tmp_path):
    ops = _routes_ops()
    _write_weights(tmp_path / "w.weights", ops[:3], 5)
    with pytest.raises(ValueError, match="exhausted"):
        load_darknet_weights(str(tmp_path / "w.weights"), ops)


@pytest.mark.slow
def test_darknet_weights_full_trunk(tmp_path):
    ops = darknet.trunk_graph()
    assert _write_weights(tmp_path / "t.weights", ops, 6) == 40_620_640
    _check_weights_equal(tmp_path / "t.weights", ops)


@pytest.mark.slow
def test_full_detector_416_matches_jax():
    jmodel = JaxDetector()
    params, state = _random_tree(jmodel.ops, 14)
    params["head"] = init_head_params(15)
    x = np.random.default_rng(1).uniform(size=(1, 416, 416, 3)).astype(np.float32)
    want, _ = jax.jit(lambda p, s, x: jmodel.apply(p, s, x))(params, state, x)
    model = FaceDetectorModel()
    model.load_state_dict(params_from_jax(params, state))
    got = model(torch.from_numpy(x)).numpy()
    print(f"416² head: max |diff| {np.abs(got - np.asarray(want)).max():.3g}, "
          f"max |head| {np.abs(got).max():.3g}")
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
