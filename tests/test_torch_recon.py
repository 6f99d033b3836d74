"""The port's face reconstruction decoder (models/recon.py and the FI
pipeline's create_face_reconst_model / reconstruct) vs the JAX package's.

Seeded identifier weights (64², dense1_dim 8) go to both packages as the
same numpy arrays; the decoder's random bias comes from the same seed (2,
the JAX package's PRNGKey(2)) and must be bit-identical. Tolerances,
measured here:
- one transposed conv vs `jax.lax.conv_transpose(padding="SAME",
  transpose_kernel=True)`: 1e-5 absolute on outputs up to ~20 (f32
  summation order; measured 1.9e-6 at stride 2). torch's `padding=1,
  output_padding=1` has the right shape and is one pixel off, which this
  test catches (measured max |diff| 18.8 on the same inputs);
- the whole decoder at 64²: 2e-5 of max |output| in eval mode (72
  transposed convs, the channel l2norms' sums and torch's vs XLA's rsqrt;
  measured 3.6e-6); 1e-3 of max |output| in train mode, where every BN
  divides by a batch standard deviation near sqrt(eps) and so magnifies
  the same rounding layer by layer (measured 2.5e-4), with the moved BN
  statistics within 1e-5.
"""

import os

import jax
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.api.config import Conf as JaxConf
from face_vijnana_yolov3_tpu.api.face_identification import (
    FaceIdentifierPipeline as JaxPipeline,
)
from face_vijnana_yolov3_tpu.models import recon as jax_recon
from face_vijnana_yolov3_tpu.models.identifier import FaceIdentifierModel as JaxIdentifier
from face_vijnana_yolov3_tpu_torch.api import face_identification as port_fi
from face_vijnana_yolov3_tpu_torch.api.config import Conf
from face_vijnana_yolov3_tpu_torch.convert import identifier_params_from_jax
from face_vijnana_yolov3_tpu_torch.models import recon

torch.set_num_threads(2)

S, D = 64, 8
DECONV_ATOL = 1e-5
RECON_TOL = 2e-5
RECON_TRAIN_TOL = 1e-3
STATE_ATOL = 1e-5


def test_recon_graph_equals_jax():
    ops = recon.recon_graph()
    assert ops == jax_recon.recon_graph()
    assert sum(op[0] == "subtract" for op in ops) == 23
    assert [op[1] for op in ops if op[0] == "deconv"][:2] == [73, 72]


@pytest.mark.parametrize("k,stride", [(3, 2), (3, 1), (1, 1)])
def test_conv_transpose_same_matches_jax(k, stride):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.normal(size=(2, 5, 5, 4)).astype(np.float32)  # NHWC, 4 = the conv's out_c
    w = rng.normal(size=(k, k, 8, 4)).astype(np.float32)  # the trunk conv's HWIO
    want = np.asarray(jax.jit(lambda a, b: jax.lax.conv_transpose(
        a, b, (stride, stride), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        transpose_kernel=True))(x, w))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)  # OIHW
    got = recon.conv_transpose_same(xt, wt, stride).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 5 * stride, 5 * stride, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=DECONV_ATOL)
    if stride == 2:  # the tempting torch padding: same shape, shifted values
        naive = torch.nn.functional.conv_transpose2d(
            xt, wt, stride=2, padding=1, output_padding=1).permute(0, 2, 3, 1).numpy()
        assert naive.shape == want.shape and np.abs(naive - want).max() > 1.0


@pytest.fixture(scope="module")
def weights():
    idm = JaxIdentifier(image_size=S, dense1_dim=D)
    params, state = jax.device_get(idm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for k in params:  # live BN-free kernels: the decoder never reads the BNs
        if k.startswith("conv_"):
            params[k]["kernel"] = params[k]["kernel"] + rng.normal(
                0, 0.01, params[k]["kernel"].shape).astype(np.float32)
    z = rng.normal(size=(3, D)).astype(np.float32)
    return params, state, z


@pytest.mark.parametrize("train", [False, True])
def test_reconstruction_matches_jax(weights, train):
    params, _state, z = weights
    jm = jax_recon.FaceReconstructionModel(image_size=S, dense1_dim=D)
    rp, rs = jm.init(jax.random.PRNGKey(2), params)
    want, want_state = jax.jit(lambda zz: jm.apply(rp, rs, zz, train=train))(z)
    pm = recon.FaceReconstructionModel(image_size=S, dense1_dim=D, device="cpu")
    sd = pm.init_state_dict(identifier_params_from_jax(params, {}))
    np.testing.assert_array_equal(sd["dense1_t.bias"].numpy(), rp["dense1_t"]["bias"])
    pm.load_state_dict(sd)
    got = pm(torch.from_numpy(z), train=train).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape == (3, S, S, 3) and np.isfinite(got).all()
    tol = RECON_TRAIN_TOL if train else RECON_TOL
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    if train:
        for key, entry in want_state.items():
            for field in ("mean", "var"):
                np.testing.assert_allclose(getattr(getattr(pm, key), field).numpy(),
                                           np.asarray(entry[field]), atol=STATE_ATOL)


def _conf(cls, **fi):
    conf = cls()
    conf.fi_conf.weights_path = "missing.weights"
    conf.fi_conf.nn_arch.image_size = S
    conf.fi_conf.nn_arch.dense1_dim = D
    for k, v in fi.items():
        setattr(conf.fi_conf, k, v)
    conf.fd_conf.weights_path = "missing.weights"
    conf.fd_conf.nn_arch.image_size = S
    return conf


def test_pipeline_reconstruct_matches_jax(weights, tmp_path, monkeypatch):
    """reconstruct() of the port's FI pipeline on the JAX pipeline's
    identifier: the same images within RECON_TOL; the decoder is saved to
    face_vijnana_recon_tpu.pt, and face_vijana_recon_load reads it back."""
    monkeypatch.chdir(tmp_path)
    params, state, z = weights
    jfi = JaxPipeline(_conf(JaxConf))
    jfi.params, jfi.state = params, state
    pfi = port_fi.FaceIdentifierPipeline(_conf(Conf), device="cpu")
    pfi.model.load_state_dict(identifier_params_from_jax(params, state))
    want = jfi.reconstruct(z)
    got = pfi.reconstruct(z)
    assert got.shape == (3, S, S, 3)
    assert np.abs(got - want).max() <= RECON_TOL * np.abs(want).max()
    assert os.path.exists(port_fi.RECON_CHECKPOINT)
    again = port_fi.FaceIdentifierPipeline(_conf(Conf, face_vijana_recon_load=True),
                                           device="cpu")
    again.create_face_reconst_model()
    np.testing.assert_array_equal(again.reconstruct(z), got)
    assert torch.equal(again.recon_model.dense1_t.weight, pfi.recon_model.dense1_t.weight)
