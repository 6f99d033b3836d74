"""Identifier training of the PyTorch port (train/trainer.train_identifier,
FaceIdentifierPipeline.train) vs the JAX package, on the CPU.

One triplet step of the whole identifier (conv_0..conv_73 + dense1 8, at
64², 4 triplets, the last a zero-weight padding row) with random and
semi_hard negatives: the JAX loss is trainer.py:371-415's loss_fn on
`FaceIdentifierModel.triplet_forward(train=True)` under jax.value_and_grad,
the port's `make_triplet_step` and `triplet_step_loss` under autograd. The
loss is a difference of two distances between unit vectors, each within
the embeddings' 1e-5 (tests/test_torch_identifier.py): 1e-5 abs [measured
1.2e-6 random / 2.2e-6 semi_hard]. The rest are tests/test_torch_train.py's
full-trunk bounds: all gradients together within 5e-3 of their norm
[4.6e-3 / 2.8e-4; most of it in the stride-2 convs], each parameter's
within 0.1 [0.021 / 0.0072] (BN over 12 samples at 2² and leaky kinks),
the BN statistics 1e-5 of their max [1.9e-7]. The semi_hard negatives
are the same rows in both. bf16 mixed precision: loss 1e-2 abs [1.8e-3],
gradients 0.3 of their norm [0.12], BN statistics 1e-3 [1.6e-4] (bf16
rounds every conv output and cotangent, in another order). Then the loop itself on a
small synthetic identity tree: device_data equals streaming bit for bit,
checkpoints with the Adam state and the trainmeta sidecar, finalize_bn
against the JAX `finalize_bn_stats` (1e-4 of each statistic's max), and
the pipeline's train() with a Keras-h5 model_path.
"""

import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.data import facedb as jax_facedb
from face_vijnana_yolov3_tpu.models.identifier import FaceIdentifierModel as JaxModel
from face_vijnana_yolov3_tpu.train import trainer as jax_trainer
from face_vijnana_yolov3_tpu_torch.api import face_identification as port_fi
from face_vijnana_yolov3_tpu_torch.api.config import Conf
from face_vijnana_yolov3_tpu_torch.convert import identifier_params_from_jax
from face_vijnana_yolov3_tpu_torch.core.checkpoints import load_opt_state, load_train_meta
from face_vijnana_yolov3_tpu_torch.data import facedb, synthetic
from face_vijnana_yolov3_tpu_torch.models import darknet
from face_vijnana_yolov3_tpu_torch.models.identifier import (
    FaceIdentifierModel,
    triplet_step_loss,
)
from face_vijnana_yolov3_tpu_torch.train import optimizer, trainer

torch.set_num_threads(2)
port_fi.DEBUG = False

S, D = 64, 8
TOL = {"float32": (1e-5, 5e-3, 0.1, 1e-5), "bfloat16": (1e-2, 0.3, None, 1e-3)}  # loss abs


@pytest.fixture(scope="module")
def model():
    jm = JaxModel(image_size=S, dense1_dim=D)
    params, state = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(4)))
    params = {k: dict(v) for k, v in params.items()}
    state = {k: dict(v) for k, v in state.items()}
    darknet.perturb_batchnorm(params, state, jm.ops, 9)
    pm = FaceIdentifierModel(image_size=S, dense1_dim=D, device="cpu")
    pm.load_state_dict(identifier_params_from_jax(params, state))
    return jm, params, state, pm


def _jax_loss_fn(jm, state, a, p, n, w, sid_a, sid_n, mining, dtype):
    """trainer.py:371-415's loss_fn, verbatim in its arithmetic."""

    def loss_fn(prm):
        out, new_state = jm.triplet_forward(prm, state, a, p, n, train=True,
                                            compute_dtype=dtype)
        d = jm.dense1_dim
        ea, ep, en = out[:, :d], out[:, d:2 * d], out[:, 2 * d:]
        d_ap = jnp.sqrt(jnp.sum((ea - ep) ** 2, axis=-1))
        if mining == "semi_hard":
            pool = jnp.concatenate([ea, ep, en], axis=0)
            pool_sid = jnp.concatenate([sid_a, sid_a, sid_n])
            pool_w = jnp.concatenate([w] * 3)
            d_all = jnp.sqrt(jnp.maximum(
                jnp.sum((ea[:, None] - pool[None]) ** 2, axis=-1), 1e-12))
            valid = (pool_sid[None, :] != sid_a[:, None]) & (pool_w[None, :] > 0.0)
            inf = jnp.float32(1e9)
            harder = valid & (d_all > d_ap[:, None])
            semi = harder & (d_all < d_ap[:, None] + 0.2)
            cand = jnp.where(
                semi.any(-1)[:, None], jnp.where(semi, d_all, inf),
                jnp.where(harder.any(-1)[:, None], jnp.where(harder, d_all, inf),
                          jnp.where(valid, d_all, inf)))
            j = jnp.argmin(cand, axis=-1)
            d_an = jnp.sqrt(jnp.sum((ea - pool[j]) ** 2, axis=-1))
        else:
            j = None
            d_an = jnp.sqrt(jnp.sum((ea - en) ** 2, axis=-1))
        per = jnp.maximum(d_ap - d_an + 0.2, 0.0)
        return jnp.sum(per * w) / jnp.sum(w), (new_state, j)

    return loss_fn


@pytest.mark.parametrize("mining,dtype", [("random", "float32"), ("semi_hard", "float32"),
                                          ("random", "bfloat16")])
def test_one_triplet_step_matches_jax(model, mining, dtype):
    jm, params, state, pm = model
    rng = np.random.default_rng(11)
    a, p, n = (rng.uniform(0, 1, (4, S, S, 3)).astype(np.float32) for _ in range(3))
    w = np.array([1, 1, 1, 0], np.float32)
    sid_a = np.array([0, 1, 2, 0], np.int32)
    sid_n = np.array([1, 2, 0, 1], np.int32)
    loss_fn = _jax_loss_fn(jm, state, *(jnp.asarray(v) for v in (a, p, n, w, sid_a, sid_n)),
                           mining, getattr(jnp, dtype))
    (jl, (jstate, jsel)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    tp, ts = darknet.split_state_dict(identifier_params_from_jax(params, state))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    cdt = getattr(torch, dtype)
    out, new_state = pm.triplet_forward(leaves, ts, *(torch.from_numpy(v) for v in (a, p, n)),
                                        compute_dtype=cdt)
    loss = triplet_step_loss(out, torch.from_numpy(w), D, mining=mining,
                             sid_a=torch.from_numpy(sid_a), sid_n=torch.from_numpy(sid_n))
    loss.backward()
    loss_tol, grad_tol, param_tol, state_tol = TOL[dtype]
    assert abs(float(loss.detach()) - float(jl)) <= loss_tol
    want_g = identifier_params_from_jax(jax.device_get(jgrads), {})
    assert set(want_g) == set(leaves)
    total = sum(float(g.norm()) ** 2 for g in want_g.values()) ** 0.5
    diff = sum(float((leaves[k].grad - g).norm()) ** 2 for k, g in want_g.items()) ** 0.5
    assert diff <= grad_tol * total, (diff, total)
    if param_tol is not None:
        errs = {k: float((leaves[k].grad - g).norm() / g.norm()) for k, g in want_g.items()
                if float(g.norm()) > 0}
        assert max(errs.values()) <= param_tol, max(errs.items(), key=lambda kv: kv[1])
    want_s = identifier_params_from_jax({}, jax.device_get(jstate))
    for k, v in want_s.items():
        assert float((new_state[k] - v).abs().max()) <= state_tol * float(v.abs().max()), k
    if mining == "semi_hard":
        # The same pool rows chosen as negatives.
        ea, ep, en = out[:, :D], out[:, D:2 * D], out[:, 2 * D:]
        pool = torch.cat([ea, ep, en]).detach()
        d_sel = torch.sqrt(((ea.detach() - pool[torch.from_numpy(np.asarray(jsel))]) ** 2).sum(-1))
        d_ap = torch.sqrt(((ea - ep) ** 2).sum(-1)).detach()
        per = torch.clamp_min(d_ap - d_sel + 0.2, 0.0)
        assert float((per * torch.from_numpy(w)).sum() / 3) == pytest.approx(float(loss),
                                                                               rel=1e-6)
    # make_triplet_step: the same loss, and params moved by Keras Adam of
    # these gradients.
    if dtype == "float32":
        opt = optimizer.KerasAdam(1e-3, 0.99, 0.99, 0.0)
        step = trainer.make_triplet_step(pm, opt, mining=mining)
        new_params, stepped, opt_state, step_loss = step(
            tp, ts, opt.init(tp), *(torch.from_numpy(v) for v in (a, p, n, w)),
            torch.from_numpy(sid_a), torch.from_numpy(sid_n))
        assert float(step_loss) == float(loss) and int(opt_state.count) == 1
        updates, _ = opt.update({k: v.grad for k, v in leaves.items()}, opt.init(tp))
        for k in tp:
            assert torch.equal(new_params[k], tp[k] + updates[k]), k


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        synthetic.make_fi_tree(str(root), 3, seed=1, image_size=96, face_sizes=(30, 60),
                               train_per_subj=3, hold_per_subj=0)
        facedb.create_subject_db_uccs(str(root), image_size=S)
        ds = facedb.TripletDataset(str(root), rng=np.random.default_rng(0),
                                   shuffle_rng=random.Random(0))
    finally:
        os.chdir(cwd)
    return root, ds


def _hps(**kw):
    return dict({"lr": 1e-4, "beta_1": 0.99, "beta_2": 0.99, "decay": 0.0,
                 "epochs": 2, "batch_size": 4}, **kw)


def _params(model):
    _, params, state, _ = model
    return darknet.split_state_dict(identifier_params_from_jax(params, state))


def test_device_data_equals_streaming_and_checkpoints(model, tree, tmp_path):
    pm = model[3]
    _, ds = tree
    runs = {}
    for dd in (True, False):
        p, s = _params(model)
        path = str(tmp_path / f"fi_{dd}.pt")
        times = []
        runs[dd] = trainer.train_identifier(
            pm, p, s, ds, _hps(), device_data=dd, checkpoint_path=path,
            history_path=path + "_history.jsonl", finalize_bn=False, epoch_times=times,
            mining="semi_hard")
        assert len(times) == 2
    (p1, s1, l1), (p0, s0, l0) = runs[True], runs[False]
    assert l1 == l0 and len(l1) == 2 * 3 and np.isfinite(l1).all()
    assert all(torch.equal(p1[k], p0[k]) for k in p1)
    assert all(torch.equal(s1[k], s0[k]) for k in s1)
    path = str(tmp_path / "fi_True.pt")
    assert load_train_meta(path) == {"qat": False}
    assert int(load_opt_state(path)["count"]) == 6
    hist = [json.loads(line) for line in open(path + "_history.jsonl")]
    assert [h["loss"] for h in hist] == l1


@pytest.mark.parametrize("kw", [{"compute_dtype": torch.bfloat16},
                                {"fakequant": True}, {"remat": True}])
def test_train_identifier_variants_run(model, tree, kw):
    """bf16 mixed precision, fake-quant QAT and remat: finite losses, the
    remainder batch padded, hps['step'] written back."""
    pm = model[3]
    p, s = _params(model)
    hps = _hps(epochs=1, batch_size=2)
    _, _, losses = trainer.train_identifier(pm, p, s, tree[1], hps, finalize_bn=False, **kw)
    assert len(losses) == hps["step"] == 5 and np.isfinite(losses).all()


def test_finalize_bn_matches_jax(model, tree):
    """The BN re-estimation over the stacked [a; p; n] batches (the true
    remainder) against the JAX finalize_bn_stats with the JAX embed."""
    jm, params, state, pm = model
    _, ds = tree
    p, s = _params(model)
    _, got, _ = trainer.train_identifier(pm, p, s, ds, _hps(epochs=0), finalize_bn=True)

    class Stacked:
        def steps(self, bs):
            return ds.steps(bs)

        def batch(self, i, bs):
            return (np.concatenate(ds.batch(i, bs)),)

    recal = jax.jit(lambda pp, ss, x: jm.embed(pp, ss, x, train=True, bn_momentum=0.0))
    want = identifier_params_from_jax({}, jax_trainer.finalize_bn_stats(
        recal, params, state, Stacked(), 4))
    assert set(want) == set(got)
    for k, v in want.items():
        assert float((got[k] - v).abs().max()) <= 1e-4 * float(v.abs().max()), k


def test_pipeline_train_exports_keras_h5(tree, tmp_path, monkeypatch):
    """FaceIdentifierPipeline.train with model_path face_identifier.h5:
    trains against the sibling .pt, exports the h5, drops the folded and
    int8 programs; a new pipeline loads the h5 with the same weights."""
    root, _ = tree
    monkeypatch.chdir(root)
    conf = Conf()
    c = conf.fi_conf
    c.raw_data_path = str(root)
    c.weights_path = "missing.weights"
    c.nn_arch.image_size = S
    c.nn_arch.dense1_dim = D
    c.hps.epochs = 1
    c.hps.batch_size = 4
    c.model_path = str(tmp_path / "face_identifier.h5")
    conf.fd_conf.weights_path = "missing.weights"
    conf.fd_conf.nn_arch.image_size = S
    fi = port_fi.FaceIdentifierPipeline(conf, precision="int8", device="cpu", seed=3)
    fi.embed(np.zeros((2, S, S, 3), np.float32))
    assert fi._q_embed is not None
    losses = fi.train()
    assert len(losses) == 3 and fi._q_embed is None and fi._folded is None
    assert os.path.exists(c.model_path) and os.path.exists(c.model_path + ".pt")
    c.model_loading = True
    again = port_fi.FaceIdentifierPipeline(conf, device="cpu")
    want = fi.model.state_dict()
    assert all(torch.equal(again.model.state_dict()[k], want[k]) for k in want)
    # The port's triplet pairs load in the JAX package (pickled ints).
    assert jax_facedb.TripletDataset(str(root), load_flag=True).img_triplet_pairs == \
        facedb.TripletDataset(str(root), load_flag=True).img_triplet_pairs
