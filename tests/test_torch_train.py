"""Detector training of the PyTorch port vs the JAX package, on the CPU.

The same numpy weights (seeded, BN statistics perturbed) and inputs go
through the JAX `apply_graph(train=True)` / `FaceDetectorModel.apply` and
the port's `darknet.apply_graph_train` / `FaceDetectorModel.apply_train`,
`jax.value_and_grad` against `torch.autograd`.

Tolerances, each measured on these seeds (in brackets) with room:
- f32 (TF32 does not exist on the CPU; both sum convs in another order):
  loss rtol 1e-5 [5e-7]; each param's gradient ||got - want|| / ||want||
  <= 1e-4 [5e-6]; BN moving statistics rtol 1e-5 of their max [1e-7].
- bf16 mixed precision: both frameworks round every conv's output and the
  backward's cotangents to bf16, in other summation orders, and BN's
  batch-statistics backward amplifies those differences: loss rtol 1e-3
  [3e-5], gradients norm-relative <= 0.3 [0.14], moving statistics 1e-3
  of their max [1e-4].
- fake-quant (f32): an ULP of difference in a conv sum moves a value across
  a rounding point of round(h / s), by one quantum; the moved value shifts
  the next BN's batch statistics and scales, so the moved set grows with
  depth (1e-5 of the elements at the first requant, most of them by the
  12th conv). The output stays within one quantum of the last requant
  (max |out| / 127) [measured 0.043 of 0.042 * 1.03]; loss rtol 1e-3
  [5e-5]; gradients norm-relative <= 0.25 [0.10]; moving statistics 1e-3
  [2e-4]. The fake-quant functions themselves, fed the same tensors, are
  bit-exact (torch.round and jnp.round both round half to even).
- Keras Adam, given the same gradients: rtol 1e-6 (f32 pow/sqrt of the
  step scalars may differ by an ULP between the two).
- finalize_bn_stats: 1e-4 of each statistic's max [1.1e-5]: f32 batch
  statistics (E[x^2] - E[x]^2 cancels), averaged in f64.
- Datasets (GT tensors, batches, the synthetic JPEGs) and `_pad_batch`:
  bit-equal. device_data and streaming, and a resumed run and an
  uninterrupted one, are bit-equal (one process, the same CPU kernels).
"""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.data import uccs as jax_uccs
from face_vijnana_yolov3_tpu.models import darknet as jax_darknet
from face_vijnana_yolov3_tpu.models import detector as jax_detector
from face_vijnana_yolov3_tpu.models.detector import FaceDetectorModel as JaxModel
from face_vijnana_yolov3_tpu.ops.letterbox import letterbox_geometry as jax_geometry
from face_vijnana_yolov3_tpu.train import optimizer as jax_optimizer
from face_vijnana_yolov3_tpu.train import trainer as jax_trainer
from face_vijnana_yolov3_tpu_torch.api.config import FdConf
from face_vijnana_yolov3_tpu_torch.api.face_detection import FaceDetectorPipeline
from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
from face_vijnana_yolov3_tpu_torch.core.checkpoints import load_opt_state
from face_vijnana_yolov3_tpu_torch.data import synthetic, uccs
from face_vijnana_yolov3_tpu_torch.models import darknet, detector
from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_geometry
from face_vijnana_yolov3_tpu_torch.train import optimizer, trainer
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import synthetic_e2e  # noqa: E402  (the JAX package's synthetic-set generator)

torch.set_num_threads(2)

TRUNCATED = jax_darknet.trunk_graph()[:16] + [("output", "trunk")]  # conv_0..conv_12
TOL = {  # (loss rtol, grad norm-relative, BN state rtol)
    "float32": (1e-5, 1e-4, 1e-5),
    "bfloat16": (1e-3, 0.3, 1e-3),
    "fakequant": (1e-3, 0.25, 1e-3),
}


def _truncated_params():
    params, state = darknet.init_graph_params(TRUNCATED, 3)
    return darknet.perturb_batchnorm(params, state, TRUNCATED, 4)


def _grad_errors(got: dict, want_tree: dict) -> dict:
    want = params_from_jax(jax.device_get(want_tree), {})
    return {k: float((got[k] - w).norm() / w.norm()) for k, w in want.items()}


def _state_error(got: dict, want_tree: dict) -> float:
    want = params_from_jax({}, jax.device_get(want_tree))
    return max(float((got[k] - w).abs().max() / w.abs().max()) for k, w in want.items())


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "fakequant"])
def test_one_step_on_a_truncated_graph_matches_jax(mode):
    """Loss, every gradient and the BN moving statistics of one train-mode
    step of conv_0..conv_12 at 64² (the tolerances of the module
    docstring)."""
    params, state = _truncated_params()
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    target = rng.normal(0, 1, (2, 8, 8, 256)).astype(np.float32)
    dtype = "float32" if mode == "fakequant" else mode
    fq = mode == "fakequant"

    def jax_loss(p):
        outs, ns = jax_darknet.apply_graph(p, state, jnp.asarray(x), TRUNCATED, train=True,
                                           compute_dtype=getattr(jnp, dtype), fakequant=fq)
        return jnp.mean(jnp.square(outs["trunk"] - target)), (outs["trunk"], ns)

    (jl, (jout, jstate)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    tp, ts = darknet.split_state_dict(params_from_jax(params, state))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    outs, new_state = darknet.apply_graph_train(tp, ts, torch.from_numpy(x), TRUNCATED,
                                                compute_dtype=getattr(torch, dtype),
                                                fakequant=fq)
    loss = torch.mean(torch.square(outs["trunk"] - torch.from_numpy(target)))
    loss.backward()
    loss_tol, grad_tol, state_tol = TOL[mode]
    assert float(loss) == pytest.approx(float(jl), rel=loss_tol)
    errs = _grad_errors({k: v.grad for k, v in tp.items()}, jgrads)
    assert set(errs) == set(tp) and max(errs.values()) <= grad_tol, errs
    assert _state_error(new_state, jstate) <= state_tol
    if fq:
        out, want = outs["trunk"].detach().numpy(), np.asarray(jout)
        quantum = float(np.abs(want).max()) / 127
        assert float(np.abs(out - want).max()) <= 1.05 * quantum


def test_fake_quant_functions_are_bit_exact():
    """_act_fq and _weight_fq on the same tensors as the JAX functions:
    the same scales, the same rounded values (NCHW/OIHW vs NHWC/HWIO)."""
    rng = np.random.default_rng(11)
    h = (rng.normal(0, 1, (2, 9, 7, 16)) * rng.uniform(0.01, 10, 16)).astype(np.float32)
    want, want_s = jax_darknet._act_fq(jnp.asarray(h))
    got, got_s = darknet._act_fq(torch.from_numpy(h).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    k = rng.normal(0, 0.1, (3, 3, 16, 8)).astype(np.float32)
    for s_in in (None, np.asarray(want_s)):
        want_k = jax_darknet._weight_fq(jnp.asarray(k), None if s_in is None else jnp.asarray(s_in))
        got_k = darknet._weight_fq(torch.from_numpy(k).permute(3, 2, 0, 1),
                                   None if s_in is None else torch.from_numpy(s_in))
        np.testing.assert_array_equal(got_k.permute(2, 3, 1, 0).numpy(), np.asarray(want_k))
    assert darknet.fakequant_skip_ops(darknet.trunk_graph()) == \
        jax_darknet.fakequant_skip_ops(jax_darknet.trunk_graph())


@pytest.fixture(scope="module")
def full():
    jm = JaxModel(image_size=64)
    params, state = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params = {k: dict(v) for k, v in params.items()}
    state = {k: dict(v) for k, v in state.items()}
    darknet.perturb_batchnorm(params, state, jm.ops, 7)
    pm = FaceDetectorModel(image_size=64, device="cpu")
    pm.load_state_dict(params_from_jax(params, state))
    return jm, params, state, pm


def test_full_trunk_step_matches_jax(full):
    """One f32 step of the whole detector (conv_0..conv_73 + head) at 64²,
    b2 with a zero-weight padding row: the weighted MSE (rtol 1e-5), the
    gradients (all of them together within 5e-3 in norm [measured 2.0e-3;
    each param within 0.1 [0.054]: at 4² and 2²
    a BN averages 32 or 8 samples, and a leaky input that an ULP moves
    across 0 changes its slope tenfold), the BN statistics (1e-5), then the
    port's train step on top."""
    jm, params, state, pm = full
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    gts = rng.uniform(0, 1, (2, 2, 2, 6)).astype(np.float32)
    w = np.array([1.0, 0.0], np.float32)

    def jax_loss(p):
        pred, ns = jm.apply(p, state, jnp.asarray(x), train=True)
        per = jnp.mean(jnp.square(pred - gts), axis=(1, 2, 3))
        return jnp.sum(per * w) / jnp.sum(w), ns

    (jl, jstate), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    tp, ts = darknet.split_state_dict(params_from_jax(params, state))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    pred, new_state = pm.apply_train(leaves, ts, torch.from_numpy(x))
    per = torch.mean(torch.square(pred - torch.from_numpy(gts)), dim=(1, 2, 3))
    loss = torch.sum(per * torch.from_numpy(w)) / torch.sum(torch.from_numpy(w))
    loss.backward()
    errs = _grad_errors({k: v.grad for k, v in leaves.items()}, jgrads)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    want_g = params_from_jax(jax.device_get(jgrads), {})
    total = sum(float(g.norm()) ** 2 for g in want_g.values()) ** 0.5
    diff = sum(float((leaves[k].grad - g).norm()) ** 2 for k, g in want_g.items()) ** 0.5
    assert diff <= 5e-3 * total, (diff, total)
    assert max(errs.values()) <= 0.1, max(errs.items(), key=lambda kv: kv[1])
    assert _state_error(new_state, jstate) <= 1e-5
    # The port's train step: the same loss and BN state, and params moved by
    # its Keras Adam update of its own gradients.
    opt = optimizer.KerasAdam(1e-3, 0.99, 0.99, 0.0)
    step = trainer.make_train_step(pm, opt)
    new_params, stepped_state, opt_state, step_loss = step(
        tp, ts, opt.init(tp), torch.from_numpy(x), torch.from_numpy(gts), torch.from_numpy(w))
    assert float(step_loss) == float(loss) and int(opt_state.count) == 1
    updates, _ = opt.update({k: v.grad for k, v in leaves.items()}, opt.init(tp))
    for k in tp:
        assert torch.equal(new_params[k], tp[k] + updates[k]), k
    assert all(torch.equal(stepped_state[k], new_state[k]) for k in new_state)


@pytest.mark.slow
def test_full_trunk_step_416_matches_jax():
    """The full-trunk f32 step at the published 416², b2: loss, gradients
    and BN statistics within the 64² case's bounds."""
    jm = JaxModel(image_size=416)
    params, state = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    params = {k: dict(v) for k, v in params.items()}
    state = {k: dict(v) for k, v in state.items()}
    darknet.perturb_batchnorm(params, state, jm.ops, 8)
    pm = FaceDetectorModel(image_size=416, device="cpu")
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (2, 416, 416, 3)).astype(np.float32)
    gts = rng.uniform(0, 1, (2, 13, 13, 6)).astype(np.float32)

    def jax_loss(p):
        pred, ns = jm.apply(p, state, jnp.asarray(x), train=True)
        return jnp.mean(jnp.square(pred - gts)), ns

    (jl, jstate), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    tp, ts = darknet.split_state_dict(params_from_jax(params, state))
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    pred, new_state = pm.apply_train(leaves, ts, torch.from_numpy(x))
    loss = FaceDetectorModel.loss(pred, torch.from_numpy(gts))
    loss.backward()
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    want_g = params_from_jax(jax.device_get(jgrads), {})
    total = sum(float(g.norm()) ** 2 for g in want_g.values()) ** 0.5
    diff = sum(float((leaves[k].grad - g).norm()) ** 2 for k, g in want_g.items()) ** 0.5
    assert diff <= 5e-3 * total, (diff, total)
    assert max(_grad_errors({k: v.grad for k, v in leaves.items()}, jgrads).values()) <= 0.1
    assert _state_error(new_state, jstate) <= 1e-5


@pytest.mark.parametrize("decay", [0.0, 1e-3])
def test_keras_adam_matches_jax_on_the_same_grads(decay):
    """Three updates of Keras Adam (beta_1 0.99, beta_2 0.99, eps 1e-7
    outside the bias correction, lr / (1 + decay t)) on the same gradients."""
    rng = np.random.default_rng(int(decay * 1e4) + 1)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    tx = jax_optimizer.keras_adam(1e-3, 0.99, 0.99, decay)
    opt = optimizer.KerasAdam(1e-3, 0.99, 0.99, decay)
    jstate = tx.init(params)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = opt.init(tparams)
    for _ in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) * 1e-2 for k, v in params.items()}
        ju, jstate = tx.update(grads, jstate)
        tu, tstate = opt.update({k: torch.from_numpy(v) for k, v in grads.items()}, tstate)
        for k in params:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-6, atol=0)
            np.testing.assert_allclose(tstate.mu[k].numpy(), np.asarray(jstate.mu[k]), rtol=1e-6)
            np.testing.assert_allclose(tstate.nu[k].numpy(), np.asarray(jstate.nu[k]), rtol=1e-6)
    assert int(tstate.count) == int(jstate.count) == 3
    restored = optimizer.coerce_adam_state(optimizer.adam_state_dict(tstate))
    assert int(restored.count) == 3 and restored.mu.keys() == tstate.mu.keys()


@pytest.mark.parametrize("n,batch", [(1, 2), (4, 4), (1, 3), (5, 8)])
def test_pad_batch_matches_jax(n, batch):
    rng = np.random.default_rng(n)
    arrays = (rng.normal(size=(n, 3, 3)).astype(np.float32),
              rng.normal(size=(n, 2)).astype(np.float32))
    got = trainer._pad_batch(arrays, batch)
    want = jax_trainer._pad_batch(arrays, batch, 1)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape[0] == batch and got[2].sum() == n


# -------------------------------------------------------------- datasets


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """A seeded synthetic set at 128² (the JAX package's generator)."""
    root = tmp_path_factory.mktemp("synthetic")
    synthetic_e2e.make_dataset(str(root), n_train=5, n_val=2, image_size=128, seed=1)
    return str(root)


def test_synthetic_set_matches_the_jax_tooling(dataset_dir, tmp_path):
    synthetic.make_dataset(str(tmp_path), n_train=5, n_val=2, image_size=128, seed=1)
    for name in sorted(os.listdir(dataset_dir)):
        assert (Path(dataset_dir) / name).read_bytes() == (tmp_path / name).read_bytes(), name


def test_build_gt_tensor_matches_jax(dataset_dir):
    df = uccs.load_gt_frame(os.path.join(dataset_dir, "training.csv"))
    groups = uccs.group_by_file(df)
    for name, rows in groups:
        rows = rows.reset_index(drop=True)
        for h, w, s in ((128, 128, 64), (100, 160, 96), (170, 90, 64)):
            got = uccs.build_gt_tensor(rows, letterbox_geometry(h, w, s), s // 32)
            want = jax_uccs.build_gt_tensor(rows, jax_geometry(h, w, s), s // 32)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(uccs.valid_row_mask(df), jax_uccs.valid_row_mask(df))


@pytest.mark.parametrize("cache", ["none", "samples", "disk"])
def test_detection_dataset_batches_match_jax(dataset_dir, cache):
    got = uccs.DetectionDataset(dataset_dir, image_size=64, grid=2, cache=cache)
    want = jax_uccs.DetectionDataset(dataset_dir, image_size=64, grid=2, cache="none")
    assert got.file_names == want.file_names and got.steps(2) == want.steps(2) == 3
    for i in range(3):
        for g, w in zip(got.batch(i, 2), want.batch(i, 2)):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


# -------------------------------------------------------------- the trainer


def _hps(**kw):
    hps = {"lr": 1e-3, "beta_1": 0.99, "beta_2": 0.99, "decay": 0.0, "epochs": 2,
           "batch_size": 2}
    hps.update(kw)
    return hps


def _train(pm, dataset, path=None, **kw):
    tp, ts = darknet.split_state_dict({k: v.clone() for k, v in pm.state_dict().items()})
    return trainer.train_detector(pm, tp, ts, dataset, kw.pop("hps", _hps()), log_every=0,
                                  checkpoint_path=path, **kw)


def test_device_data_equals_streaming(full, dataset_dir):
    pm = full[3]
    ds = uccs.DetectionDataset(dataset_dir, image_size=64, grid=2, cache="samples")
    a = _train(pm, ds, device_data=True, finalize_bn=False)
    b = _train(pm, ds, device_data=False, finalize_bn=False)
    assert a[2] == b[2] and len(a[2]) == 6  # 3 steps (5 images at b2) x 2 epochs
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k


def test_checkpoint_every_resumes_to_the_same_params(full, dataset_dir, tmp_path,
                                                    monkeypatch):
    """checkpoint_every=1 saves params, BN state and Adam state after epoch
    1 (with the trainmeta qat flag), then at the end; a run of one epoch
    saved the same way and trained one more epoch from its checkpoint gives
    the uninterrupted 2-epoch run bit for bit. The history is one JSON line
    a step, as the JAX package writes it."""
    from face_vijnana_yolov3_tpu_torch.core import checkpoints

    saves = []
    real_save = checkpoints.save_checkpoint
    monkeypatch.setattr(checkpoints, "save_checkpoint",
                        lambda *a, **kw: (saves.append(a[0]), real_save(*a, **kw)))
    pm = full[3]
    ds = uccs.DetectionDataset(dataset_dir, image_size=64, grid=2, cache="samples")
    path = str(tmp_path / "m.pt")
    whole = _train(pm, ds, path, finalize_bn=False, fakequant=True, checkpoint_every=1,
                   history_path=path + "_h.jsonl")
    assert saves == [path, path]
    first = str(tmp_path / "first.pt")
    _train(pm, ds, first, finalize_bn=False, fakequant=True, hps=_hps(epochs=1))
    sd, opt = checkpoints.load_checkpoint(first), load_opt_state(first)
    assert checkpoints.load_train_meta(first) == {"qat": True} and int(opt["count"]) == 3
    conf = FdConf(mode="train", model_loading=True, model_path=first)
    conf.nn_arch.image_size = 64
    fd = FaceDetectorPipeline(conf, device="cpu")  # what mode=train resumes from
    assert fd._ckpt_qat and int(fd.opt_state["count"]) == 3
    pm2 = FaceDetectorModel(image_size=64, device="cpu")
    pm2.load_state_dict(sd)
    resumed = _train(pm2, ds, finalize_bn=False, fakequant=True, hps=_hps(epochs=1),
                     init_opt_state=opt)
    for k in whole[0]:
        assert torch.equal(resumed[0][k], whole[0][k]), k
    assert resumed[2] == whole[2][3:]
    lines = [json.loads(s) for s in open(path + "_h.jsonl")]
    assert lines == [{"step": i, "loss": v} for i, v in enumerate(whole[2])]
    want = tmp_path / "jax_h.jsonl"
    jax_trainer._write_history(str(want), whole[2])
    assert want.read_text() == Path(path + "_h.jsonl").read_text()


def test_finalize_bn_stats_matches_jax(full, dataset_dir):
    jm, params, state, pm = full
    ds = uccs.DetectionDataset(dataset_dir, image_size=64, grid=2, cache="samples")
    recal = jax.jit(lambda p, s, x: jm.apply(p, s, x, train=True, bn_momentum=0.0))
    want = jax_trainer.finalize_bn_stats(recal, params, state, ds, 2)
    tp, ts = darknet.split_state_dict(pm.state_dict())
    got = trainer.finalize_bn_stats(pm, tp, ts, ds, 2)
    assert _state_error(got, want) <= 1e-4


def test_losses_match_jax():
    rng = np.random.default_rng(9)
    t = rng.uniform(0, 1, (2, 3, 3, 6)).astype(np.float32)
    p = rng.normal(0, 1, (2, 3, 3, 6)).astype(np.float32)
    np.testing.assert_allclose(
        float(FaceDetectorModel.loss(torch.from_numpy(p), torch.from_numpy(t))),
        float(jax_detector.FaceDetectorModel.loss(p, t)), rtol=1e-6)
    np.testing.assert_allclose(
        detector.fd_loss(torch.from_numpy(t), torch.from_numpy(p)).numpy(),
        np.asarray(jax_detector.fd_loss(t, p)), rtol=1e-6, atol=1e-7)
