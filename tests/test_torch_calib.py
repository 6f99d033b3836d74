"""int8 calibration of the port: msegrid and PTQ bias correction vs the JAX package.

Same host-numpy weights on both sides (the JAX init with seeded BN
statistics, `darknet.perturb_batchnorm`), the full trunk at 64², 4 images.

Tolerances:
- msegrid on the same activations (the input position: `ops=[]`): the
  scales are bit-identical. The per-candidate MSEs are sums taken in
  another order, but the pick is a window in f64 on the host (the largest
  ratio within 1 + tol of the channel's minimum), and each scale is the
  exact channel max times that ratio, so an ULP in an MSE moves nothing.
- msegrid through the trunk: scales rtol 1e-4 [measured 3.9e-5], the bound
  of the other calibrations (tests/test_torch_quant.py): each position's
  max comes from two f32 forwards whose convs sum in another order.
- bias correction, on the JAX package's scales: kernel_q, w_scale and the
  scales bit-identical. The corrected biases agree within 1e-6 [5e-7]
  through conv_29 (stage 3 at 8², 256 samples a channel).
  Deeper, a requantisation that an ULP of a mean moves by one step changes
  the next convs' means, and the move spreads; at 4² and 2² there are only
  64 and 16 samples a channel to average it out: every conv's bias within
  0.5 of its largest correction [0.33].
"""

import jax
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.models import quant as jax_quant
from face_vijnana_yolov3_tpu.models.detector import FaceDetectorModel as JaxModel
from face_vijnana_yolov3_tpu_torch.convert import folded_from_jax, params_from_jax
from face_vijnana_yolov3_tpu_torch.models import darknet, quant
from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    jm = JaxModel(image_size=64)
    params, state = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params = {k: dict(v) for k, v in params.items()}
    state = {k: dict(v) for k, v in state.items()}
    darknet.perturb_batchnorm(params, state, jm.ops, 7)
    folded = jax.device_get(jm.fold(params, state))
    pm = FaceDetectorModel(image_size=64, device="cpu")
    pm.load_state_dict(params_from_jax(params, state))
    x = np.random.default_rng(2).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    return jm, folded, pm, x


def test_msegrid_ratios_match_jax():
    for n, lo in ((96, 0.002), (7, 0.1)):
        np.testing.assert_array_equal(quant.msegrid_ratios(n, lo),
                                      jax_quant.msegrid_ratios(n, lo))


@pytest.mark.parametrize("tol", [None, 0.2])
def test_msegrid_on_the_same_activations_is_bit_identical(tol):
    """64 channels with lone outliers, heavy tails and dead channels: the
    input position of an empty graph, where both sides see one tensor."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (4, 24, 24, 64)).astype(np.float32)
    x[..., :16] *= rng.uniform(1e-3, 10, 16).astype(np.float32)
    x[0, 0, 0, 16:32] = 300.0  # a lone outlier stretches maxabs
    x[..., 32:40] = rng.standard_t(2, (4, 24, 24, 8))
    x[..., 40:44] = 0.0
    pct = "msegrid" if tol is None else f"msegrid:{tol}"
    want = jax_quant.calibrate_folded({}, x, [], percentile=pct)
    got = quant.calibrate_folded({}, torch.from_numpy(x), [], percentile=pct)
    assert len(got) == len(want) == 1
    assert got[0].dtype == want[0].dtype == np.float64
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[0] < np.abs(x).reshape(-1, 64).max(0) / 127).any()  # some channel clips


def test_msegrid_through_the_trunk_matches_jax(setup):
    jm, folded, pm, x = setup
    want = jax_quant.calibrate_folded(folded, x, jm.ops, percentile="msegrid")
    got = quant.calibrate_folded(pm.fold(), torch.from_numpy(x), jm.ops,
                                 percentile="msegrid")
    assert len(got) == len(want) == len(jm.ops) + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=0)


def test_bias_corrected_qparams_match_jax(setup):
    """On p99.99 scales, where the JAX package measured the correction to
    help (quant.py:432-441)."""
    jm, folded, pm, x = setup
    want = jax_quant.quantize_folded(folded, x, jm.ops, percentile=99.99,
                                     bias_correct=True)
    plain = quant.quantize_folded(folded_from_jax(folded), None, jm.ops,
                                  act_scales=want["act_scales"])
    got = quant.quantize_folded(folded_from_jax(folded), torch.from_numpy(x), jm.ops,
                                act_scales=want["act_scales"], bias_correct=True)
    for g, w in zip(got["act_scales"], want["act_scales"]):
        np.testing.assert_array_equal(g, w)
    for op in jm.ops:
        if op[0] != "conv":
            continue
        k = f"conv_{op[1]}"
        np.testing.assert_array_equal(got[k]["kernel_q"].numpy(),
                                      np.asarray(want[k]["kernel_q"]).transpose(3, 0, 1, 2))
        np.testing.assert_array_equal(got[k]["w_scale"].numpy(), np.asarray(want[k]["w_scale"]))
        g, w = got[k]["bias"].numpy(), np.asarray(want[k]["bias"])
        correction = float(np.abs(w - plain[k]["bias"].numpy()).max())
        assert correction > 0, k
        bound = 1e-6 if op[1] <= 29 else 0.5 * correction
        assert float(np.abs(g - w).max()) <= bound, (k, float(np.abs(g - w).max()), correction)


def test_bias_correction_stops_at_a_bf16_tail_and_excludes_islands(setup):
    jm, folded, pm, x = setup
    with pytest.raises(ValueError, match="mutually exclusive"):
        quant.quantize_folded(pm.fold(), torch.from_numpy(x), jm.ops, bias_correct=True,
                              bf16_ops=(14,))
    q = quant.quantize_folded(pm.fold(), torch.from_numpy(x), jm.ops, percentile=99.99,
                              bf16_tail_blocks=2, bias_correct=True)
    q0 = quant.quantize_folded(pm.fold(), torch.from_numpy(x), jm.ops,
                               act_scales=q["act_scales"], bf16_tail_blocks=2)
    cut = q["tail_start"]
    convs = [op[1] for op in jm.ops[:cut] if op[0] == "conv"]
    tail = [f"conv_{op[1]}" for op in jm.ops[cut:] if op[0] == "conv"]
    assert tail and all(torch.equal(q["tail"][k]["bias"], q0["tail"][k]["bias"]) for k in tail)
    assert any(not torch.equal(q[f"conv_{i}"]["bias"], q0[f"conv_{i}"]["bias"]) for i in convs)
