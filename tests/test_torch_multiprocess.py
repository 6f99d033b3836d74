"""Data- and tensor-parallel training of the port on 2 CPU processes.

Two processes joined by `parallel.mesh.init_distributed(device="cpu")`
(gloo) run the port's training collectives (train/trainer.py) and are
held against one process of the port and against the JAX package, whose
single SPMD program over the global batch is the reference (the 8-device
virtual CPU mesh of tests/conftest.py; JAX's own 2-process proof is
tests/test_multiprocess.py). The workers are this file run as a script;
they import neither jax nor the JAX package, and start once for the
module, while the parent computes its references.

The global batch is a remainder batch: 5 images padded to 8 (`_pad_batch`)
so that rank 0 holds rows 0-3 and rank 1 row 4 and all three zero-weight
padding rows; the triplet batch is 3 triplets padded to 4 (rank 1 holds
the padding row). 64² inputs, the whole detector and identifier (dense1 of
8), weights from the JAX initialisers with perturbed BN statistics.

Tolerances, with what was measured on these seeds in brackets:
- float64 (conv_0..conv_12 at 32², plain and fake-quant): the collectives
  are exact, so 2 processes equal 1 process up to f64 rounding: loss rtol
  1e-12 [1.1e-16], all gradients within 1e-10 of their norm [1.4e-15],
  BN statistics 1e-12 of their max [1.5e-16].
- f32, the whole detector: 2 processes vs 1 process and vs JAX within
  tests/test_torch_train.py's full-trunk bounds: loss rtol 1e-5 [1.6e-6],
  all gradients within 5e-3 of their norm [4.4e-4], each within 0.1
  [0.014] (BN over 8-32 samples at 4² and 2², and leaky kinks, amplify
  the f32 rounding of the BN sums, which the ranks add in another order),
  BN statistics 1e-5 of their max [2.2e-7].
- Fake-quant, the whole detector: a BN moment an ULP off moves a value
  across a rounding point of the int8 grid and the moved set grows with
  depth (tests/test_torch_train.py), as between one process and JAX
  [loss 2.7e-3, gradients 0.13]: loss rtol 2e-2 [7.1e-3], all gradients
  within 0.25 of their norm [0.14], BN statistics 5e-3 [1.4e-3].
- Identifier steps (semi-hard, DP over 2 ranks and TP of dense1 over 2):
  tests/test_torch_train_identifier.py's f32 bounds, against 1 process
  and against JAX: loss 1e-5 abs [8.3e-7], all gradients 5e-3 of their
  norm [2.0e-3 vs JAX; 1.6e-4 DP and 9.5e-7 TP vs 1 process], each 0.1
  [0.016], BN 1e-5 [2.7e-7].
- The mesh training loops run each step through a program keyed on the
  mesh (`mesh.mesh_key`); on the CPU a program is its eager step, so the
  loops equal the eager mesh steps bit for bit. In float64 (conv_0..conv_12
  at 32², plain and fake-quant, one train_detector step over 2 ranks) the
  loss is within 1e-12 of one process's and the BN statistics within
  1e-12 of their max, the bounds above; the params after Keras Adam
  within 1e-12 [measured 0].
- One train step (train_detector over the mesh, and train_identifier at
  model_axis 2 vs JAX train_identifier on make_mesh(2, model_axis=2)):
  the loss as above; Keras Adam's first step moves each parameter by
  lr·g/(|g| + 1e-7), about ±lr, so a gradient that rounding moves across
  0 flips it by 2·lr: all parameters within 2·lr + 1e-6 [2.0e-3], and at
  most 1 % of them by more than 1e-6 [0.07 % detector, 0.45 % identifier].
"""

import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
S, D = 64, 8
N_REAL, B = 5, 8            # detector: 5 real rows padded to 8
T_REAL, TB = 3, 4           # triplets: 3 real rows padded to 4
HPS = {"lr": 1e-3, "beta_1": 0.99, "beta_2": 0.99, "decay": 0.0, "epochs": 1}


# ------------------------------------------------------------------ data

class DetSet:
    """steps/batch over in-memory (images, gts), the DetectionDataset API."""

    def __init__(self, x, g):
        self.x, self.g = x, g

    def steps(self, bs):
        return -(-len(self.x) // bs)

    def batch(self, i, bs):
        return self.x[i * bs:(i + 1) * bs], self.g[i * bs:(i + 1) * bs]


class TripletSet:
    """steps/batch/batch_subject_codes over in-memory triplets, the
    TripletDataset API."""

    def __init__(self, a, p, n, sa, sn):
        self.a, self.p, self.n, self.sa, self.sn = a, p, n, sa, sn

    def steps(self, bs):
        return -(-len(self.a) // bs)

    def batch(self, i, bs):
        sl = slice(i * bs, (i + 1) * bs)
        return self.a[sl], self.p[sl], self.n[sl]

    def batch_subject_codes(self, i, bs):
        sl = slice(i * bs, (i + 1) * bs)
        return self.sa[sl], self.sn[sl]


def _inputs():
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (N_REAL, S, S, 3)).astype(np.float32)
    g = rng.uniform(0, 1, (N_REAL, S // 32, S // 32, 6)).astype(np.float32)
    a, p, n = (rng.uniform(0, 1, (T_REAL, S, S, 3)).astype(np.float32) for _ in range(3))
    sa = np.array([0, 1, 2], np.int32)
    sn = np.array([1, 2, 0], np.int32)
    return x, g, (a, p, n, sa, sn)


class Truncated:
    """conv_0..conv_12 of the trunk as a `model.apply_train`."""

    def apply_train(self, params, state, x, **kw):
        from face_vijnana_yolov3_tpu_torch.models import darknet

        ops = darknet.trunk_graph()[:16] + [("output", "trunk")]
        outs, new_state = darknet.apply_graph_train(params, state, x, ops, **kw)
        return outs["trunk"], new_state


def _truncated_case():
    """f64 params of conv_0..conv_12 (perturbed BN) and a 32² remainder batch."""
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
    from face_vijnana_yolov3_tpu_torch.models import darknet

    ops = darknet.trunk_graph()[:16] + [("output", "trunk")]
    params, state = darknet.perturb_batchnorm(*darknet.init_graph_params(ops, 3), ops, 4)
    p, s = darknet.split_state_dict(params_from_jax(params, state))
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (N_REAL, 32, 32, 3))
    t = rng.normal(0, 1, (N_REAL, 4, 4, 256))
    return ({k: v.double() for k, v in p.items()}, {k: v.double() for k, v in s.items()}), (x, t)


def _padded(arrays, batch, n_dev=2):
    from face_vijnana_yolov3_tpu_torch.train.trainer import _pad_batch

    return [torch.from_numpy(np.ascontiguousarray(t))
            for t in _pad_batch(arrays, batch, n_dev)]


# ------------------------------------------------------------------ worker

def _digest(tree):
    """tree with each tensor replaced by the sha256 of its bytes (equal
    digests: equal bit for bit); other leaves kept."""
    import hashlib

    if isinstance(tree, torch.Tensor):
        return hashlib.sha256(tree.detach().contiguous().numpy().tobytes()).hexdigest()
    if isinstance(tree, dict):
        return {k: _digest(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_digest(v) for v in tree)
    return tree


class _Keys:
    """Records the key of every program a ProgramCache runs."""

    seen: list = []

    @classmethod
    def cache(cls):
        from face_vijnana_yolov3_tpu_torch.core.programs import ProgramCache

        class Recording(ProgramCache):
            def run(self, key, fn, *inputs, donate=0):
                cls.seen.append(key)
                return super().run(key, fn, *inputs, donate=donate)

        return Recording

    @classmethod
    def take(cls) -> list:
        out, cls.seen = cls.seen, []
        return out


def _f64_loop(mesh):
    """One train_detector step of the f64 truncated graph, plain and
    fake-quant: (losses, params, state) each."""
    from face_vijnana_yolov3_tpu_torch.train import trainer

    case = torch.load(os.environ["FVY_CASE"], weights_only=False)
    params, state = case["trunc"]
    x, t = case["trunc_xy"]
    return {fq: trainer.train_detector(Truncated(), dict(params), dict(state), DetSet(x, t),
                                       dict(HPS, batch_size=B), mesh=mesh, finalize_bn=False,
                                       device_data=False, fakequant=fq,
                                       compute_dtype=torch.float64)
            for fq in (False, True)}


def _worker(rank: int, world: int, port: str, workdir: str) -> None:
    """One rank: every distributed step of the module, results to workdir."""
    torch.set_num_threads(2)
    from face_vijnana_yolov3_tpu_torch.core.programs import ProgramError
    from face_vijnana_yolov3_tpu_torch.models import darknet
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
    from face_vijnana_yolov3_tpu_torch.models.identifier import FaceIdentifierModel
    from face_vijnana_yolov3_tpu_torch.parallel import mesh as mesh_lib
    from face_vijnana_yolov3_tpu_torch.train import trainer
    from face_vijnana_yolov3_tpu_torch.train.optimizer import KerasAdam

    assert mesh_lib.init_distributed(f"localhost:{port}", world, rank, device="cpu")
    os.environ["FVY_CASE"] = os.path.join(workdir, "case.pt")
    case = torch.load(os.environ["FVY_CASE"], weights_only=False)
    out = {}
    dp = mesh_lib.make_mesh()
    tp = mesh_lib.make_mesh(model_axis=2)
    data = mesh_lib.axis_group(dp, "data")
    trainer.ProgramCache = _Keys.cache()
    eager_step = trainer.program_step

    tparams, tstate = case["trunc"]
    x, g, w = (mesh_lib.batch_sharded(t, dp) for t in _padded(case["trunc_xy"], B))
    for fq in (False, True):
        out[f"f64_fq{int(fq)}"] = trainer.detector_loss_grads(
            Truncated(), tparams, tstate, x.double(), g.double(), w, fakequant=fq,
            compute_dtype=torch.float64, group=data)

    det = FaceDetectorModel(image_size=S, device="cpu")
    params, state = darknet.split_state_dict(case["det"])
    x, g, w = (mesh_lib.batch_sharded(t, dp) for t in _padded(case["det_xy"], B))
    for fq in (False, True):
        loss, grads, new_state = trainer.detector_loss_grads(
            det, params, state, x, g, w, fakequant=fq, group=data)
        out[f"det_fq{int(fq)}"] = (loss, grads, new_state)
    p1, s1, l1 = trainer.train_detector(det, params, state, DetSet(*case["det_xy"]),
                                        dict(HPS, batch_size=B), mesh=dp,
                                        finalize_bn=False, device_data=False)
    out["det_loop"] = (l1, p1, s1)
    out["det_loop_keys"] = _Keys.take()
    out["f64_loop"] = _f64_loop(dp)
    _Keys.take()

    # The same step under a key whose carry changed shape: refused before
    # it runs (so before any collective), on every rank.
    step = trainer.program_step(trainer.ProgramCache("cpu", train=True),
                                ("truncated", *mesh_lib.mesh_key(dp)),
                                trainer.make_train_step(Truncated(), KerasAdam(1e-3),
                                                        compute_dtype=torch.float64,
                                                        group=data), 3)
    tparams64, tstate64 = case["trunc"]
    xs, ts_, ws = (mesh_lib.batch_sharded(t, dp) for t in _padded(case["trunc_xy"], B))
    feeds = (xs.double(), ts_.double(), ws)
    step(tparams64, tstate64, KerasAdam(1e-3).init(tparams64), *feeds)
    cut = dict(tparams64, **{"conv_0.weight": tparams64["conv_0.weight"][:16]})
    try:
        step(cut, tstate64, KerasAdam(1e-3).init(cut), *feeds)
        out["shape_change"] = None
    except ProgramError as e:
        out["shape_change"] = str(e)
    _Keys.take()

    idm = FaceIdentifierModel(image_size=S, dense1_dim=D, device="cpu")
    iparams, istate = darknet.split_state_dict(case["id"])
    feeds = _padded(case["trip"], TB)  # a, p, n, sa, sn, w
    a, p, n, sa, sn, tw = feeds
    for name, mesh in (("id_dp", dp), ("id_tp", tp)):
        rows = [mesh_lib.batch_sharded(t, mesh) for t in (a, p, n, tw, sa, sn)]
        shard = mesh_lib.put_tree(iparams, mesh_lib.shard_identifier_params(mesh, iparams),
                                  mesh)
        out[name] = trainer.triplet_loss_grads(idm, shard, istate, *rows,
                                               mining="semi_hard", mesh=mesh)
    ckpt = os.path.join(workdir, "id_tp.pt")
    _, _, tl = trainer.train_identifier(idm, iparams, istate, TripletSet(*case["trip"]),
                                        dict(HPS, batch_size=TB), mesh=tp,
                                        checkpoint_path=ckpt, finalize_bn=False,
                                        device_data=False, mining="semi_hard")
    out["id_loop_losses"] = tl
    out["id_loop_keys"] = _Keys.take()

    # The eager mesh steps (no program) of both loops.
    trainer.program_step = lambda programs, key, step, n: step
    p2, s2, l2 = trainer.train_detector(det, params, state, DetSet(*case["det_xy"]),
                                        dict(HPS, batch_size=B), mesh=dp,
                                        finalize_bn=False, device_data=False)
    out["det_loop_eager"] = (l2, p2, s2)
    ip, _, tl2 = trainer.train_identifier(idm, iparams, istate, TripletSet(*case["trip"]),
                                          dict(HPS, batch_size=TB), mesh=tp,
                                          finalize_bn=False, device_data=False,
                                          mining="semi_hard")
    out["id_loop_eager_losses"] = tl2
    trainer.program_step = eager_step
    if rank:  # the other ranks' results as digests, and rank 1's dense1 rows and keys
        out = dict(_digest(out), id_tp_dense1=out["id_tp"][1]["dense1.weight"],
                   keys=(out["det_loop_keys"], out["id_loop_keys"]))
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


# ------------------------------------------------------------------ parent

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs():
    """Start the 2 ranks, compute the 1-process and JAX references
    meanwhile, then collect the ranks' results."""
    import jax

    from face_vijnana_yolov3_tpu.models.detector import FaceDetectorModel as JaxDet
    from face_vijnana_yolov3_tpu.models.identifier import FaceIdentifierModel as JaxId
    from face_vijnana_yolov3_tpu_torch.convert import (
        identifier_params_from_jax,
        params_from_jax,
    )
    from face_vijnana_yolov3_tpu_torch.models import darknet

    torch.set_num_threads(2)
    jd = JaxDet(image_size=S)
    dparams, dstate = jax.tree.map(np.asarray, jd.init(jax.random.PRNGKey(0)))
    dparams = {k: dict(v) for k, v in dparams.items()}
    dstate = {k: dict(v) for k, v in dstate.items()}
    darknet.perturb_batchnorm(dparams, dstate, jd.ops, 3)
    ji = JaxId(image_size=S, dense1_dim=D)
    iparams, istate = jax.tree.map(np.asarray, ji.init(jax.random.PRNGKey(4)))
    iparams = {k: dict(v) for k, v in iparams.items()}
    istate = {k: dict(v) for k, v in istate.items()}
    darknet.perturb_batchnorm(iparams, istate, ji.ops, 9)
    x, g, trip = _inputs()
    trunc, trunc_xy = _truncated_case()
    case = {"det": params_from_jax(dparams, dstate), "det_xy": (x, g),
            "id": identifier_params_from_jax(iparams, istate), "trip": trip,
            "trunc": trunc, "trunc_xy": trunc_xy}
    tmp = tempfile.TemporaryDirectory()
    torch.save(case, os.path.join(tmp.name, "case.pt"))
    os.environ["FVY_CASE"] = os.path.join(tmp.name, "case.pt")
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", port, tmp.name],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(2)]
    try:
        refs = _references(case, (jd, dparams, dstate), (ji, iparams, istate))
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [torch.load(os.path.join(tmp.name, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    ckpt = os.path.join(tmp.name, "id_tp.pt")
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import load_checkpoint

    yield {"ranks": ranks, "refs": refs, "case": case, "ckpt_sd": load_checkpoint(ckpt)}
    tmp.cleanup()


def _references(case, jdet, jid):
    """The one-process port and the JAX references of every worker step."""
    import jax
    import jax.numpy as jnp

    from face_vijnana_yolov3_tpu.parallel.mesh import make_mesh
    from face_vijnana_yolov3_tpu.train import trainer as jax_trainer
    from face_vijnana_yolov3_tpu_torch.models import darknet
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
    from face_vijnana_yolov3_tpu_torch.models.identifier import FaceIdentifierModel
    from face_vijnana_yolov3_tpu_torch.train import trainer

    refs = {}
    x, g, w = _padded(case["trunc_xy"], B)
    for fq in (False, True):
        refs[f"f64_fq{fq:d}"] = trainer.detector_loss_grads(
            Truncated(), *case["trunc"], x.double(), g.double(), w, fakequant=fq,
            compute_dtype=torch.float64)
    det = FaceDetectorModel(image_size=S, device="cpu")
    params, state = darknet.split_state_dict(case["det"])
    x, g, w = _padded(case["det_xy"], B)
    jd, jp, js = jdet
    for fq in (False, True):
        refs[f"det_fq{int(fq)}"] = trainer.detector_loss_grads(det, params, state, x, g, w,
                                                               fakequant=fq)

        def jax_loss(prm, fq=fq):
            pred, ns = jd.apply(prm, js, jnp.asarray(x.numpy()), train=True, fakequant=fq)
            per = jnp.mean(jnp.square(pred - g.numpy()), axis=(1, 2, 3))
            return jnp.sum(per * w.numpy()) / jnp.sum(w.numpy()), ns

        refs[f"jax_det_fq{int(fq)}"] = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jp)
    lp, ls, ll = trainer.train_detector(det, params, state, DetSet(*case["det_xy"]),
                                        dict(HPS, batch_size=B), finalize_bn=False,
                                        device_data=False)
    refs["det_loop"] = (ll, lp, ls)
    refs["f64_loop"] = _f64_loop(None)

    idm = FaceIdentifierModel(image_size=S, dense1_dim=D, device="cpu")
    iparams, istate = darknet.split_state_dict(case["id"])
    a, p, n, sa, sn, tw = _padded(case["trip"], TB)
    refs["id"] = trainer.triplet_loss_grads(idm, iparams, istate, a, p, n, tw, sa, sn,
                                            mining="semi_hard")
    ji, jp, js = jid
    fn = _jax_semi_hard_loss(ji, js, *(jnp.asarray(t.numpy()) for t in (a, p, n, tw, sa, sn)))
    (jl, (jstate, jidx)), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(jp)
    refs["jax_id"] = (jl, jgrads, jstate, jidx)
    jparams, _, jlosses = jax_trainer.train_identifier(
        ji, jp, js, TripletSet(*case["trip"]), dict(HPS, batch_size=TB),
        mesh=make_mesh(2, model_axis=2), finalize_bn=False, mining="semi_hard",
        device_data=False)
    refs["jax_id_loop"] = (jlosses, jax.device_get(jparams))
    return refs


def _jax_semi_hard_loss(jm, state, a, p, n, w, sid_a, sid_n):
    """The JAX trainer's semi-hard triplet loss_fn (trainer.py:371-415)."""
    import jax.numpy as jnp

    def loss_fn(prm):
        out, new_state = jm.triplet_forward(prm, state, a, p, n, train=True)
        d = jm.dense1_dim
        ea, ep, en = out[:, :d], out[:, d:2 * d], out[:, 2 * d:]
        d_ap = jnp.sqrt(jnp.sum((ea - ep) ** 2, axis=-1))
        pool = jnp.concatenate([ea, ep, en], axis=0)
        pool_sid = jnp.concatenate([sid_a, sid_a, sid_n])
        pool_w = jnp.concatenate([w] * 3)
        d_all = jnp.sqrt(jnp.maximum(jnp.sum((ea[:, None] - pool[None]) ** 2, axis=-1),
                                     1e-12))
        valid = (pool_sid[None, :] != sid_a[:, None]) & (pool_w[None, :] > 0.0)
        inf = jnp.float32(1e9)
        harder = valid & (d_all > d_ap[:, None])
        semi = harder & (d_all < d_ap[:, None] + 0.2)
        cand = jnp.where(semi.any(-1)[:, None], jnp.where(semi, d_all, inf),
                         jnp.where(harder.any(-1)[:, None], jnp.where(harder, d_all, inf),
                                   jnp.where(valid, d_all, inf)))
        j = jnp.argmin(cand, axis=-1)
        d_an = jnp.sqrt(jnp.sum((ea - pool[j]) ** 2, axis=-1))
        per = jnp.maximum(d_ap - d_an + 0.2, 0.0)
        return jnp.sum(per * w) / jnp.sum(w), (new_state, j)

    return loss_fn


# ------------------------------------------------------------------ checks

def _norm_errors(got: dict, want: dict):
    """(all gradients' error over their norm, each gradient's)."""
    total = sum(float(v.norm()) ** 2 for v in want.values()) ** 0.5
    diff = sum(float((got[k] - v).norm()) ** 2 for k, v in want.items()) ** 0.5
    each = {k: float((got[k] - v).norm() / max(float(v.norm()), 1e-30))
            for k, v in want.items()}
    return diff / total, each


def _state_error(got: dict, want: dict) -> float:
    return max(float((got[k] - v).abs().max() / v.abs().max()) for k, v in want.items())


def _jax_grads(tree, identifier: bool = False):
    import jax

    from face_vijnana_yolov3_tpu_torch.convert import (
        identifier_params_from_jax,
        params_from_jax,
    )

    convert = identifier_params_from_jax if identifier else params_from_jax
    return convert(jax.device_get(tree), {})


@pytest.mark.parametrize("fq", [0, 1], ids=["plain", "fakequant"])
def test_dp_step_in_float64_equals_one_process(runs, fq):
    """The collectives (global BN moments, global fake-quant maxabs, the
    global weight sum, the gradient sum) are exact: in float64 one
    data-parallel step equals the whole batch in one process to f64
    rounding."""
    (loss, grads, new_state), r1 = (r[f"f64_fq{fq}"] for r in runs["ranks"])
    one_loss, one_grads, one_state = runs["refs"][f"f64_fq{fq}"]
    assert _digest((loss, grads, new_state)) == r1
    assert float(loss) == pytest.approx(float(one_loss), rel=1e-12)
    total, _ = _norm_errors(grads, one_grads)
    assert total <= 1e-10, total
    assert _state_error(new_state, one_state) <= 1e-12


@pytest.mark.parametrize("fq", [0, 1], ids=["f32", "fakequant"])
def test_dp_detector_step_matches_one_process_and_jax(runs, fq):
    """Loss, gradients and BN moving statistics of one data-parallel step
    of the whole detector (rank 1 holding all the padding) against the
    whole batch in one process and against jax.value_and_grad of the JAX
    train step's loss (the module docstring's bounds)."""
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax

    r0, r1 = (r[f"det_fq{fq}"] for r in runs["ranks"])
    loss, grads, new_state = r0
    assert _digest(r0) == r1  # every rank holds the global loss, grads and state
    one_loss, one_grads, one_state = runs["refs"][f"det_fq{fq}"]
    (jl, jstate), jgrads = runs["refs"][f"jax_det_fq{fq}"]
    loss_tol, grad_tol, each_tol, state_tol = ((1e-5, 5e-3, 0.1, 1e-5) if not fq
                                               else (2e-2, 0.25, None, 5e-3))
    for ref_loss, ref_grads, ref_state in (
            (one_loss, one_grads, one_state),
            (jl, _jax_grads(jgrads), params_from_jax({}, jax_state(jstate)))):
        assert float(loss) == pytest.approx(float(ref_loss), rel=loss_tol)
        total, each = _norm_errors(grads, ref_grads)
        assert total <= grad_tol, total
        if each_tol is not None:
            assert max(each.values()) <= each_tol, max(each.items(), key=lambda kv: kv[1])
        assert _state_error(new_state, ref_state) <= state_tol


def jax_state(tree):
    import jax

    return jax.device_get(tree)


def test_dp_train_detector_loop_matches_one_process(runs):
    """train_detector over the mesh (broadcast, padding to the data axis,
    each rank its rows): the same loss and, after Keras Adam, the same
    params and BN statistics on both ranks as one process (f32 bounds)."""
    (l0, p0, s0), r1 = (r["det_loop"] for r in runs["ranks"])
    ol, op, os_ = runs["refs"]["det_loop"]
    assert _digest((l0, p0, s0)) == r1 and len(l0) == 1
    assert l0[0] == pytest.approx(ol[0], rel=1e-5)
    # Adam's first step is about lr·sign(g): compare the moves, not the values.
    moves = {k: p0[k] - op[k] for k in op}
    assert max(float(v.abs().max()) for v in moves.values()) <= 2 * HPS["lr"] + 1e-6
    moved = sum(int((v.abs() > 1e-6).sum()) for v in moves.values())
    assert moved <= 0.01 * sum(v.numel() for v in moves.values()), moved
    assert _state_error(s0, os_) <= 1e-5


def test_mesh_loops_run_their_program_keys(runs):
    """Both mesh loops step through one program key each, which names the
    mesh's shape and the rank's coordinates, the same sequence on every
    rank up to the coordinates; the eager mesh steps give the same losses,
    params and BN statistics bit for bit."""
    r0, r1 = runs["ranks"]
    for rank, keys in enumerate((r0["det_loop_keys"], r1["keys"][0])):
        assert keys == [("detector", "torch.float32", False, "mesh", (2, 1), (rank, 0),
                         (B // 2, S, S, 3), (B // 2, S // 32, S // 32, 6), (B // 2,))]
    for rank, keys in enumerate((r0["id_loop_keys"], r1["keys"][1])):
        assert len(keys) == 1
        assert keys[0][:8] == ("identifier", "torch.float32", "semi_hard", False, False,
                               "mesh", (1, 2), (0, rank))
    assert _digest(r0["det_loop"]) == _digest(r0["det_loop_eager"]) == r1["det_loop_eager"]
    assert r0["id_loop_losses"] == r0["id_loop_eager_losses"]
    assert r1["id_loop_losses"] == r1["id_loop_eager_losses"]


@pytest.mark.parametrize("fq", [False, True], ids=["plain", "fakequant"])
def test_f64_mesh_program_loop_equals_one_process(runs, fq):
    """train_detector through the mesh program in float64 against one
    process: the loss and BN statistics within the float64 bounds, the
    params within 1e-12 after Keras Adam (module docstring)."""
    p0, s0, l0 = runs["ranks"][0]["f64_loop"][fq]
    assert _digest((p0, s0, l0)) == runs["ranks"][1]["f64_loop"][fq]
    p1, s1, l1 = runs["refs"]["f64_loop"][fq]
    assert len(l0) == len(l1) == 1
    assert l0[0] == pytest.approx(l1[0], rel=1e-12)
    assert _state_error(s0, s1) <= 1e-12
    assert max(float((p0[k] - v).abs().max()) for k, v in p1.items()) <= 1e-12


def test_mesh_program_refuses_a_carry_of_another_shape(runs):
    """A carry whose shape differs from its key's first call raises
    ProgramError on every rank, before any collective runs."""
    for r in runs["ranks"]:
        msg = r["shape_change"]
        assert isinstance(msg, str) and "takes" in msg and "'mesh', (2, 1)" in msg, msg


@pytest.mark.parametrize("name", ["id_dp", "id_tp"])
def test_triplet_step_semi_hard_matches_one_process_and_jax(runs, name):
    """One semi-hard triplet step, data-parallel over 2 ranks (the mining
    pool gathered from both) or with dense1's kernel split over 2 model
    ranks, against model_axis 1 in one process and against the JAX loss:
    loss, gradients (dense1's kernel gathered from the two ranks' rows) and
    BN statistics."""
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax

    (l0, g0, s0), (l1, g1, s1) = (r[name] for r in runs["ranks"])
    assert _digest(l0) == l1 and _digest(s0) == s1
    assert all(_digest(v) == g1[k] for k, v in g0.items() if k != "dense1.weight")
    if name == "id_tp":  # each model rank holds its rows of dense1
        g0 = dict(g0, **{"dense1.weight": torch.cat([g0["dense1.weight"],
                                                      runs["ranks"][1]["id_tp_dense1"]],
                                                     dim=-1)})
    else:
        assert _digest(g0["dense1.weight"]) == g1["dense1.weight"]
    ol, og, os_ = runs["refs"]["id"]
    jl, jg, js, _ = runs["refs"]["jax_id"]
    for loss, grads, state in ((ol, og, os_), (jl, _jax_grads(jg, identifier=True),
                                               params_from_jax({}, jax_state(js)))):
        assert abs(float(l0) - float(loss)) <= 1e-5
        total, each = _norm_errors(g0, grads)
        assert total <= 5e-3, total
        assert max(each.values()) <= 0.1, max(each.items(), key=lambda kv: kv[1])
        assert _state_error(s0, state) <= 1e-5


def test_tp_train_identifier_matches_jax_and_loads_at_model_axis_1(runs):
    """train_identifier at model_axis 2 (one step): the loss of JAX
    train_identifier on make_mesh(2, model_axis=2), the parameters within
    Adam's first-step bound, and a checkpoint that holds the whole dense1
    kernel: it loads into a model_axis-1 identifier and converts with
    identifier_params_to_jax unchanged."""
    from face_vijnana_yolov3_tpu_torch.convert import (
        identifier_params_from_jax,
        identifier_params_to_jax,
    )
    from face_vijnana_yolov3_tpu_torch.models.identifier import FaceIdentifierModel

    losses = [r["id_loop_losses"] for r in runs["ranks"]]
    jlosses, jparams = runs["refs"]["jax_id_loop"]
    assert losses[0] == losses[1] and len(losses[0]) == 1
    assert abs(losses[0][0] - float(jlosses[0])) <= 1e-5
    sd = runs["ckpt_sd"]
    assert sd["dense1.weight"].shape == (D, (S // 32) ** 2 * 1024)
    model = FaceIdentifierModel(image_size=S, dense1_dim=D, device="cpu")
    model.load_state_dict(sd)
    back, _ = identifier_params_to_jax(sd)
    want = identifier_params_from_jax(jparams, {})
    moves = {k: sd[k] - v for k, v in want.items()}
    assert max(float(v.abs().max()) for v in moves.values()) <= 2 * HPS["lr"] + 1e-6
    moved = sum(int((v.abs() > 1e-6).sum()) for v in moves.values())
    assert moved <= 0.01 * sum(v.numel() for v in moves.values()), moved
    np.testing.assert_array_equal(back["dense1"]["kernel"], sd["dense1.weight"].numpy().T)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
