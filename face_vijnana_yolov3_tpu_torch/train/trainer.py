"""Training loops (the reference's fit_generator replacement).

Port of face_vijnana_yolov3_tpu/train/trainer.py (`_pad_batch`,
`train_detector`, `finalize_bn_stats`, `_write_history`, and the triplet
loop `train_identifier`, :294-551):
steps = ceil(N / batch) with the remainder in the last batch (padded with
zero-weight rows), Keras Adam (train/optimizer.py), weighted MSE, BN moving
statistics by the Keras momentum rule, then one momentum-0 pass that
re-estimates them. The identifier trains on the triplet loss over one trunk
pass of the stacked [anchor; positive; negative] batch (BN statistics over
all 3B images), with random or in-batch semi-hard negatives.

Data and tensor parallelism (`mesh`, parallel/mesh.py): JAX runs one SPMD
program over the GLOBAL batch; here each rank of the "data" axis runs its
contiguous rows of every global batch (the padding of a remainder batch
lands on the last ranks), and four collectives give the global program's
numbers: the BN batch moments and the fake-quant maxabs over all ranks'
rows (darknet.apply_graph_train), the loss as the global weighted sum over
the global weight sum (each rank's share, summed), and the semi-hard pool
gathered from all ranks in the global [a; p; n] order. Gradients are then
summed over "data" (not averaged, as DDP would), and every rank runs the
same Adam update. With model_axis > 1 each "model" rank keeps its rows of
the identifier's dense1 kernel and their Adam moments
(models/identifier.dense_l2norm); checkpoints and the returned params hold
the whole kernel. mesh=None is one process with no collective.

Precision: f32 trains with TF32 off for cuDNN and cuBLAS (the JAX f32
contract is Precision.HIGHEST); compute_dtype=torch.bfloat16 is mixed
precision: each conv casts its input and kernel to bf16 (models/darknet.
apply_graph_train), while BN statistics, the loss, the master params and the
Adam state stay f32. Explicit casts, not torch.autocast, whose op list is
not the JAX program's.

Programs: each step runs through one captured training program
(core/programs.py, `program_step`), as the JAX package runs one jitted
step; `make_train_step` and `make_triplet_step` stay the eager steps a
program captures. With a mesh the program holds the step's collectives
too (NCCL captures them into the graph): the differentiable all-reduces
of the BN moments and the loss, the fake-quant maxabs MAX, the semi-hard
pool gather and the gradient sum, forward and backward. Their keys add
the mesh's shape and this rank's coordinates (`mesh.mesh_key`). Three
rules make that safe: the communicators exist before any capture (the
broadcast of `mesh.replicated` makes the world's, the warm-up call before
each capture runs every collective of the step once); autograd runs the
backward's collectives on the stream of their forward, the capture
stream; and every rank runs the same keys in the same order (the same
global batches, padded alike), since a collective one rank replays and
another does not would hang both. `finalize_bn_stats` replays one
inference program per batch shape (the JAX `recal`). On the CPU (gloo
included) a program is its eager step.

Reproducibility: both loops (and models/qat.distill_folded) run under
`deterministic()`, so two runs from the same seeds end on the same bits, as
the JAX package's do, and a replayed step equals the eager one.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch

from face_vijnana_yolov3_tpu_torch.core.programs import ProgramCache
from face_vijnana_yolov3_tpu_torch.data.pipeline import prefetch_batches
from face_vijnana_yolov3_tpu_torch.train.optimizer import (
    AdamState,
    KerasAdam,
    adam_state_dict,
    coerce_adam_state,
)


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms and TF32 off for the block (a training
    call): cuDNN's deterministic algorithms without autotuning (autotuning
    picks by timing, so two runs could pick two algorithms), and
    `torch.use_deterministic_algorithms(True)`, which also needs cuBLAS's
    fixed workspace (`CUBLAS_WORKSPACE_CONFIG`, set when the package is
    imported), without its NaN fill of every `torch.empty`: no step reads
    memory it did not write, and the fill cost 3-6 % of a step on an H100
    (PERF.md §6, profile_train.py). TF32 off in cuDNN and cuBLAS, the JAX f32
    contract. Every flag comes back as it was after the block, also on an
    exception, so serving after a training call runs as before it."""
    import torch.utils.deterministic as det

    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
             torch.get_float32_matmul_precision(),
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             det.fill_uninitialized_memory)
    try:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = True, False, False
        torch.set_float32_matmul_precision("highest")
        torch.use_deterministic_algorithms(True)
        det.fill_uninitialized_memory = False
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = saved[:3]
        torch.set_float32_matmul_precision(saved[3])
        torch.use_deterministic_algorithms(saved[4], warn_only=saved[5])
        det.fill_uninitialized_memory = saved[6]


def _carry_leaves(carry, like) -> list:
    """The tensors of `carry` (dicts of tensors and AdamStates) in the
    order of `like`, a carry of the same structure: dicts by like's keys,
    an AdamState as its count, then its moments by like's keys."""
    out = []
    for c, ref in zip(carry, like, strict=True):
        if isinstance(ref, AdamState):
            out += [c.count, *(c.mu[k] for k in ref.mu), *(c.nu[k] for k in ref.mu)]
        else:
            out += [c[k] for k in ref]
    return out


def _carry_like(like, leaves) -> tuple:
    """The inverse of `_carry_leaves`: `like`'s structure over `leaves`."""
    out, i = [], 0
    for ref in like:
        if isinstance(ref, AdamState):
            keys, n = list(ref.mu), len(ref.mu)
            out.append(AdamState(count=leaves[i],
                                 mu=dict(zip(keys, leaves[i + 1:i + 1 + n])),
                                 nu=dict(zip(keys, leaves[i + 1 + n:i + 1 + 2 * n]))))
            i += 1 + 2 * n
        else:
            out.append(dict(zip(ref, leaves[i:i + len(ref)])))
            i += len(ref)
    return tuple(out)


def program_step(programs: ProgramCache, key: tuple, step, n_carry: int):
    """`step(*carry, *batch) → (*carry, loss)` through one training program
    of `programs` per `key` and batch shapes (the JAX package's jitted
    step). The first `n_carry` arguments, dicts of tensors and AdamStates
    (params, BN state, optimizer state), are the program's donated carry
    (core/programs.py): on the card the returned carry is the program's
    static inputs, which its next replay overwrites, so only the newest
    carry may be kept. On the CPU this is `step` itself."""

    def run(*args):
        carry, batch = args[:n_carry], args[n_carry:]
        flat = _carry_leaves(carry, carry)
        n = len(flat)

        def flat_step(*t):
            *new, loss = step(*_carry_like(carry, t[:n]), *t[n:])
            return (*_carry_leaves(new, carry), loss)

        out = programs.run(key + tuple(tuple(x.shape) for x in batch), flat_step,
                           *flat, *batch, donate=n)
        return (*_carry_like(carry, out[:n]), out[n])

    return run


def _pad_batch(arrays: tuple, batch_size: int, n_dev: int = 1):
    """Pad a remainder batch to `batch_size` (rounded up to a multiple of
    n_dev) by repeating row 0, and return (*padded, weights) with weight 0
    on the padding rows, so the loss ignores them (trainer.py:25-45)."""
    n = arrays[0].shape[0]
    target = max(batch_size, n_dev)
    if target % n_dev:
        target += n_dev - target % n_dev
    if n == target:
        return (*arrays, np.ones(n, np.float32))
    pad = target - n
    padded = tuple(np.concatenate([x, np.repeat(x[:1], pad, axis=0)]) for x in arrays)
    weights = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return (*padded, weights)


def _sum_over(tensors: list, group) -> list:
    """The elementwise sums of same-dtype tensors over `group` (one
    all-reduce of their flattened concatenation)."""
    if group is None:
        return tensors
    import torch.distributed as dist

    flat = torch._utils._flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=group)
    return list(torch._utils._unflatten_dense_tensors(flat, tensors))


def _apply_grads(params, opt_state, opt, keys, grads):
    updates, opt_state = opt.update(dict(zip(keys, grads)), opt_state)
    with torch.no_grad():
        new_params = dict(zip(keys, torch._foreach_add(
            [params[k].detach() for k in keys], [updates[k] for k in keys])))
    return new_params, opt_state


def detector_loss_grads(model, params, state, images, gts, weights, *,
                        compute_dtype=torch.float32, fakequant: bool = False,
                        group=None):
    """(loss, grads, new_state) of one detector step: the weighted MSE
    (per-image mean over the head, then the weighted batch mean; all-ones
    weights give Keras 'mse') and its gradients by key. With a data-parallel
    `group`, images/gts/weights are this rank's rows and loss and grads are
    the global batch's (summed over the group)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    pred, new_state = model.apply_train(leaves, state, images, compute_dtype=compute_dtype,
                                        fakequant=fakequant, group=group)
    per = torch.mean(torch.square(pred - gts), dim=(1, 2, 3))
    loss = torch.sum(per * weights) / _sum_over([torch.sum(weights)], group)[0]
    keys = list(leaves)
    grads = _sum_over(list(torch.autograd.grad(loss, [leaves[k] for k in keys])), group)
    return _sum_over([loss.detach()], group)[0], dict(zip(keys, grads)), new_state


def make_train_step(model, opt: KerasAdam, *, compute_dtype=torch.float32,
                    fakequant: bool = False, group=None):
    """step(params, state, opt_state, images, gts, weights) → (params,
    state, opt_state, loss): `detector_loss_grads`, Keras Adam, p + u.
    params are leaf tensors; the returned ones are new leaves."""

    def step(params, state, opt_state, images, gts, weights):
        loss, grads, new_state = detector_loss_grads(
            model, params, state, images, gts, weights, compute_dtype=compute_dtype,
            fakequant=fakequant, group=group)
        keys = list(grads)
        params, opt_state = _apply_grads(params, opt_state, opt, keys,
                                         [grads[k] for k in keys])
        return params, new_state, opt_state, loss

    return step


def triplet_loss_grads(model, params, state, a, p, n, weights, sid_a=None, sid_n=None,
                       *, compute_dtype=torch.float32, mining: str = "random",
                       remat: bool | int = False, fakequant: bool = False, mesh=None):
    """(loss, grads, new_state) of one triplet step (trainer.py:362-418):
    one trunk pass over [a; p; n], the weighted triplet loss
    (models/identifier.triplet_step_loss; semi_hard takes the subject
    codes). With a mesh: this rank's rows over "data" (the semi-hard pool
    gathered whole), and this "model" rank's dense1 rows; grads summed over
    "data", keyed like `params` (dense1 sliced)."""
    from face_vijnana_yolov3_tpu_torch.models.identifier import triplet_step_loss
    from face_vijnana_yolov3_tpu_torch.parallel import mesh as mesh_lib

    group = mesh_lib.axis_group(mesh, "data")
    tp = None
    if mesh is not None:
        tp = (mesh_lib.axis_group(mesh, "model"),
              mesh_lib.dense1_rows(mesh, model.flat_dim))
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    out, new_state = model.triplet_forward(leaves, state, a, p, n,
                                           compute_dtype=compute_dtype, remat=remat,
                                           fakequant=fakequant, group=group, tp=tp)
    pool = None
    if group is not None and mining == "semi_hard":
        pool = (mesh_lib.all_gather_rows(out, group),
                *(mesh_lib.all_gather_cat(t, group) for t in (weights, sid_a, sid_n)))
    loss = triplet_step_loss(out, weights, model.dense1_dim, mining=mining,
                             sid_a=sid_a, sid_n=sid_n, pool=pool,
                             weight_sum=_sum_over([torch.sum(weights)], group)[0])
    keys = list(leaves)
    grads = _sum_over(list(torch.autograd.grad(loss, [leaves[k] for k in keys])), group)
    return _sum_over([loss.detach()], group)[0], dict(zip(keys, grads)), new_state


def make_triplet_step(model, opt: KerasAdam, *, compute_dtype=torch.float32,
                      mining: str = "random", remat: bool | int = False,
                      fakequant: bool = False, mesh=None):
    """step(params, state, opt_state, a, p, n, weights[, sid_a, sid_n]) →
    (params, state, opt_state, loss) for the identifier: `triplet_loss_grads`,
    Keras Adam, p + u."""

    def step(params, state, opt_state, a, p, n, weights, sid_a=None, sid_n=None):
        loss, grads, new_state = triplet_loss_grads(
            model, params, state, a, p, n, weights, sid_a, sid_n,
            compute_dtype=compute_dtype, mining=mining, remat=remat,
            fakequant=fakequant, mesh=mesh)
        keys = list(grads)
        params, opt_state = _apply_grads(params, opt_state, opt, keys,
                                         [grads[k] for k in keys])
        return params, new_state, opt_state, loss

    return step


def _adam_to(opt_state, device):
    opt_state.count = opt_state.count.to(device)
    opt_state.mu = {k: v.to(device) for k, v in opt_state.mu.items()}
    opt_state.nu = {k: v.to(device) for k, v in opt_state.nu.items()}
    return opt_state


@deterministic()
def train_detector(model, params: dict, state: dict, dataset, hps: dict, *,
                   mesh=None, log_every: int = 1, checkpoint_path: str | None = None,
                   init_opt_state=None, history_path: str | None = None,
                   finalize_bn: bool = True, compute_dtype=None,
                   checkpoint_every: int = 0, device_data: bool | None = None,
                   fakequant: bool = False):
    """Train the face detector; returns (params, state, losses).

    params/state: state-dict-named tensors (`darknet.split_state_dict`) on
    the training device. hps: lr, beta_1, beta_2, decay, epochs, batch_size
    (the reference schema); hps["step"] is written back, as the reference's
    Sequence does. compute_dtype None/f32 = strict f32, bfloat16 = mixed
    precision (module docstring). fakequant: quantization-aware training
    (int8 fake-quant at the serving requant positions, straight-through).
    Each step replays one captured program (key: "detector", the dtype,
    fakequant, `mesh.mesh_key`, the batch shapes); the whole call runs
    under `deterministic()`.

    device_data: keep the whole stacked set (steps, batch, ...) on the card
    and slice it per step; None turns it on when it fits the
    FVY_DEVICE_DATA_BUDGET bytes (default 4e9). Same batches, same order and
    the same update as the streaming path, which prefetches each batch on a
    thread with a pinned upload.

    checkpoint_every: also save params, BN state and Adam state every N
    epochs (a killed run resumes through model_loading). Checkpoints are
    `.pt` with the trainmeta sidecar {"qat": fakequant}.

    mesh: data parallelism over the mesh's "data" axis (module docstring):
    every rank passes the same dataset, params and hps; rank 0's params,
    state and Adam state are broadcast first, a remainder batch is padded
    to a multiple of the mesh's ranks (JAX pads to its devices), and each
    rank of the "data" axis trains on its rows.
    Every rank returns the same params, state and global losses; only
    global rank 0 writes the checkpoint and the history.
    """
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import save_checkpoint
    from face_vijnana_yolov3_tpu_torch.parallel import mesh as mesh_lib

    dtype = compute_dtype if compute_dtype is not None else torch.float32
    device = next(iter(params.values())).device
    batch_size = int(hps["batch_size"])
    steps = dataset.steps(batch_size)
    hps["step"] = steps  # the reference's runtime overwrite
    # Padded to a multiple of the mesh's ranks, as JAX pads to its devices.
    n_dev = 1 if mesh is None else mesh.size()
    opt = KerasAdam(hps["lr"], hps["beta_1"], hps["beta_2"], hps["decay"])
    opt_state = _adam_to(coerce_adam_state(init_opt_state) if init_opt_state is not None
                         else opt.init(params), device)
    params, state = mesh_lib.replicated((params, state), mesh)
    opt_state = _adam_replicated(opt_state, mesh)
    step = program_step(ProgramCache(device, train=True),
                        ("detector", str(dtype), fakequant, *mesh_lib.mesh_key(mesh)),
                        make_train_step(model, opt, compute_dtype=dtype, fakequant=fakequant,
                                        group=mesh_lib.axis_group(mesh, "data")), 3)

    def make_batch(i):
        padded = _pad_batch(dataset.batch(i, batch_size), batch_size, n_dev)
        images, gts, weights = (mesh_lib.batch_sharded(torch.from_numpy(a), mesh)
                                for a in padded)
        if dtype == torch.bfloat16:
            # The forward casts to bf16 first anyway: half the upload bytes.
            images = images.to(torch.bfloat16)
        return images.contiguous(), gts.contiguous(), weights.contiguous()

    if device_data is None:
        im0, gt0, _ = make_batch(0)
        budget = float(os.environ.get("FVY_DEVICE_DATA_BUDGET", 4e9))
        nbytes = im0.numel() * im0.element_size() + gt0.numel() * gt0.element_size()
        device_data = steps * nbytes <= budget
    if device_data:
        stacked = [make_batch(i) for i in range(steps)]
        data = [torch.stack([s[j] for s in stacked]).to(device) for j in range(3)]
        del stacked

    def save(path):
        if mesh_lib.is_main_process():
            save_checkpoint(path, {**params, **state}, meta={"qat": bool(fakequant)},
                            opt_state=adam_state_dict(opt_state))

    losses: list = []
    for epoch in range(int(hps["epochs"])):
        t0 = time.time()
        batches = ((data[0][i], data[1][i], data[2][i]) for i in range(steps)) \
            if device_data else prefetch_batches(make_batch, steps, device=device)
        for images, gts, weights in batches:
            params, state, opt_state, loss = step(params, state, opt_state,
                                                  images, gts, weights)
            losses.append(loss)
        if log_every and epoch % log_every == 0:
            print(f"epoch {epoch + 1}/{hps['epochs']}  loss {float(losses[-1]):.6f}  "
                  f"{time.time() - t0:.1f}s")
        if (checkpoint_every and checkpoint_path
                and (epoch + 1) % checkpoint_every == 0
                and (epoch + 1) < int(hps["epochs"])):
            save(checkpoint_path)
            _write_history(history_path, [float(v) for v in losses])

    losses = [float(v) for v in torch.stack(losses).cpu()] if losses else []
    _write_history(history_path, losses)
    # The step's program and its memory pool go before the recalibration
    # captures its own; the carry lives outside the pool.
    del step
    if finalize_bn:
        # Whole batches on every rank, as the JAX package's unsharded
        # recalibration; rank 0's result is kept everywhere.
        state = mesh_lib.replicated(
            finalize_bn_stats(model, params, state, dataset, batch_size), mesh)
    if checkpoint_path:
        save(checkpoint_path)
    return params, state, losses


def _adam_replicated(opt_state, mesh, shardings=None):
    """Rank 0's Adam state on every rank, the moments cut to `shardings`
    (parallel/mesh.put_tree); None and no mesh keep it as it is."""
    from face_vijnana_yolov3_tpu_torch.parallel import mesh as mesh_lib

    if mesh is None:
        return opt_state
    shardings = shardings or {}
    return type(opt_state)(count=mesh_lib.replicated(opt_state.count, mesh),
                           mu=mesh_lib.put_tree(opt_state.mu, shardings, mesh),
                           nu=mesh_lib.put_tree(opt_state.nu, shardings, mesh))


@deterministic()
def train_identifier(model, params: dict, state: dict, triplet_dataset, hps: dict, *,
                     mesh=None, checkpoint_path: str | None = None, init_opt_state=None,
                     history_path: str | None = None, finalize_bn: bool = True,
                     compute_dtype=None, checkpoint_every: int = 0,
                     device_data: bool | None = None, mining: str = "random",
                     remat: bool | int = False, epoch_times: list | None = None,
                     fakequant: bool = False):
    """Train the triplet embedder (models/identifier.py); returns (params,
    state, losses). trainer.py:294-551 of the JAX package.

    triplet_dataset: data/facedb.TripletDataset (batches of (a, p, n)
    crops; `batch_subject_codes` for semi_hard). A remainder batch is padded
    with zero-weight rows (`_pad_batch`). compute_dtype None/f32 = strict
    f32 (TF32 off), bfloat16 = mixed precision. mining "random" keeps the
    negative the dataset drew; "semi_hard" re-selects it in the batch
    (identifier.triplet_step_loss). remat checkpoints residual-block
    segments (True every one, an int N the first N) with
    torch.utils.checkpoint. fakequant: int8 fake-quant QAT of the trunk.
    device_data / checkpoint_every / the history: as `train_detector` (the
    stacked a/p/n crops are 3x the image bytes). finalize_bn re-estimates
    the BN statistics over the stacked [a; p; n] batches. epoch_times, when
    given, receives each epoch's wall seconds. Steps replay one captured
    program each (key: "identifier", the dtype, mining, remat, fakequant,
    `mesh.mesh_key`, the batch shapes); the call runs under
    `deterministic()`.

    mesh: data parallelism over "data" as in `train_detector`, and with
    model_axis > 1 dense1's tensor parallelism over "model": this rank
    keeps the kernel rows `mesh.dense1_rows` and their Adam moments. The
    returned params and the checkpoints hold the whole kernel (gathered),
    so a `.pt` written at any model_axis loads at 1.
    """
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import save_checkpoint
    from face_vijnana_yolov3_tpu_torch.parallel import mesh as mesh_lib

    dtype = compute_dtype if compute_dtype is not None else torch.float32
    device = next(iter(params.values())).device
    batch_size = int(hps["batch_size"])
    steps = triplet_dataset.steps(batch_size)
    hps["step"] = steps
    # Padded to a multiple of the mesh's ranks, as JAX pads to its devices.
    n_dev = 1 if mesh is None else mesh.size()
    opt = KerasAdam(hps["lr"], hps["beta_1"], hps["beta_2"], hps["decay"])
    opt_state = _adam_to(coerce_adam_state(init_opt_state) if init_opt_state is not None
                         else opt.init(params), device)
    pspec = mesh_lib.shard_identifier_params(mesh, params) if mesh is not None else {}
    params = mesh_lib.put_tree(params, pspec, mesh) if mesh is not None else params
    state = mesh_lib.replicated(state, mesh)
    opt_state = _adam_replicated(opt_state, mesh, pspec)
    step = program_step(ProgramCache(device, train=True),
                        ("identifier", str(dtype), mining, remat, fakequant,
                         *mesh_lib.mesh_key(mesh)),
                        make_triplet_step(model, opt, compute_dtype=dtype, mining=mining,
                                          remat=remat, fakequant=fakequant, mesh=mesh), 3)
    semi = mining == "semi_hard"

    def make_batch(i):
        arrays = triplet_dataset.batch(i, batch_size)
        if semi:
            sa, sn = triplet_dataset.batch_subject_codes(i, batch_size)
            *apn, sa, sn, w = _pad_batch((*arrays, sa, sn), batch_size, n_dev)
        else:
            *apn, w = _pad_batch(arrays, batch_size, n_dev)
        rows = lambda x: mesh_lib.batch_sharded(torch.from_numpy(x), mesh).contiguous()  # noqa: E731
        apn = [rows(x) for x in apn]
        if dtype == torch.bfloat16:
            apn = [x.to(torch.bfloat16) for x in apn]
        feeds = (*apn, rows(w))
        if semi:
            feeds += (rows(sa), rows(sn))
        return feeds

    if device_data is None:
        b0 = make_batch(0)
        budget = float(os.environ.get("FVY_DEVICE_DATA_BUDGET", 4e9))
        device_data = steps * sum(x.numel() * x.element_size() for x in b0) <= budget
    if device_data:
        stacked = [make_batch(i) for i in range(steps)]
        data = [torch.stack([s[j] for s in stacked]).to(device)
                for j in range(len(stacked[0]))]
        del stacked

    def whole():
        """params and Adam state with dense1's kernel gathered whole."""
        if mesh is None:
            return params, opt_state
        return (mesh_lib.gather_tree(params, pspec, mesh), type(opt_state)(
            count=opt_state.count, mu=mesh_lib.gather_tree(opt_state.mu, pspec, mesh),
            nu=mesh_lib.gather_tree(opt_state.nu, pspec, mesh)))

    def save(path):
        full, full_opt = whole()  # a collective: every rank takes part
        if mesh_lib.is_main_process():
            save_checkpoint(path, {**full, **state}, meta={"qat": bool(fakequant)},
                            opt_state=adam_state_dict(full_opt))

    losses: list = []
    for epoch in range(int(hps["epochs"])):
        t0 = time.time()
        batches = (tuple(d[i] for d in data) for i in range(steps)) \
            if device_data else prefetch_batches(make_batch, steps, device=device)
        for feeds in batches:
            params, state, opt_state, loss = step(params, state, opt_state, *feeds)
            losses.append(loss)
        if epoch_times is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            epoch_times.append(time.time() - t0)
        print(f"identifier epoch {epoch + 1}: loss {float(losses[-1]):.6f}")
        if (checkpoint_every and checkpoint_path
                and (epoch + 1) % checkpoint_every == 0
                and (epoch + 1) < int(hps["epochs"])):
            save(checkpoint_path)
            _write_history(history_path, [float(v) for v in losses])

    losses = [float(v) for v in torch.stack(losses).cpu()] if losses else []
    _write_history(history_path, losses)
    del step  # the step's program and its pool, before the recalibration's
    params, opt_state = whole()
    pspec = {}  # whole from here on: `whole` and `save` gather nothing more
    if finalize_bn:

        class _Stacked:
            """Triplet batches as (images,) for the BN re-estimation."""

            def steps(self, bs):
                return triplet_dataset.steps(bs)

            def batch(self, i, bs):
                return (np.concatenate(triplet_dataset.batch(i, bs)),)

        state = mesh_lib.replicated(
            finalize_bn_stats(model, params, state, _Stacked(), batch_size), mesh)
    if checkpoint_path:
        save(checkpoint_path)
    return params, state, losses


@torch.no_grad()
def finalize_bn_stats(model, params: dict, state: dict, dataset, batch_size: int, *,
                      max_batches: int | None = None) -> dict:
    """Re-estimate the BN moving statistics over the training set with the
    params frozen (trainer.py:233-266): a train-mode f32 forward with
    momentum 0 per batch (the true remainder, not padded) gives each
    batch's statistics, averaged in float64 on the host, then f32.

    Each forward replays one captured inference program (the JAX package's
    jitted `recal`), key ("recal", the model's class, the batch shape): the
    remainder batch has a program of its own. The params and state are
    closed over, fixed for the call; the host sums stay outside."""
    device = next(iter(params.values())).device
    steps = dataset.steps(batch_size)
    if max_batches is not None:
        steps = min(steps, max_batches)
    programs = ProgramCache(device)
    names: list = []  # the statistics' keys, in the programs' output order

    def recal(images):
        _, bstats = model.apply_train(params, state, images, bn_momentum=0.0)
        names[:] = bstats
        return tuple(bstats.values())

    sums = None
    for i in range(steps):
        images = torch.from_numpy(dataset.batch(i, batch_size)[0]).to(device)
        out = programs.run(("recal", type(model).__name__, tuple(images.shape)),
                           recal, images)
        host = {k: v.cpu().numpy().astype(np.float64) for k, v in zip(names, out, strict=True)}
        sums = host if sums is None else {k: sums[k] + host[k] for k in sums}
    if sums is None:
        return state
    return {k: torch.from_numpy((v / steps).astype(np.float32)).to(device)
            for k, v in sums.items()}


def _write_history(history_path, losses):
    """One JSON line {"step": i, "loss": loss} a step (trainer.py:269-277),
    written by global rank 0 only."""
    from face_vijnana_yolov3_tpu_torch.parallel.mesh import is_main_process

    if not history_path or not is_main_process():
        return
    with open(history_path, "w") as f:
        for i, loss in enumerate(losses):
            f.write(json.dumps({"step": i, "loss": loss}) + "\n")
