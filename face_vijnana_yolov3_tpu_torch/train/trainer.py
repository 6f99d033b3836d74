"""Detector training loop (the reference's fit_generator replacement).

Port of face_vijnana_yolov3_tpu/train/trainer.py:25-292 (`_pad_batch`,
`train_detector`, `finalize_bn_stats`, `_write_history`) for one card:
steps = ceil(N / batch) with the remainder in the last batch (padded with
zero-weight rows), Keras Adam (train/optimizer.py), weighted MSE, BN moving
statistics by the Keras momentum rule, then one momentum-0 pass that
re-estimates them. Multi-GPU data parallelism is ROADMAP.md queue 1 item
11; here `n_dev` is 1.

Precision: f32 trains with TF32 off for cuDNN and cuBLAS (the JAX f32
contract is Precision.HIGHEST); compute_dtype=torch.bfloat16 is mixed
precision: each conv casts its input and kernel to bf16 (models/darknet.
apply_graph_train), while BN statistics, the loss, the master params and the
Adam state stay f32. Explicit casts, not torch.autocast, whose op list is
not the JAX program's.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from face_vijnana_yolov3_tpu_torch.data.pipeline import prefetch_batches
from face_vijnana_yolov3_tpu_torch.train.optimizer import (
    KerasAdam,
    adam_state_dict,
    coerce_adam_state,
)


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


def make_train_step(model, opt: KerasAdam, *, compute_dtype=torch.float32,
                    fakequant: bool = False):
    """step(params, state, opt_state, images, gts, weights) → (params,
    state, opt_state, loss): forward, weighted MSE (per-image mean over
    the head, then the weighted batch mean; all-ones weights give Keras
    'mse'), gradients, Keras Adam, p + u. params are leaf tensors; the
    returned ones are new leaves."""

    def step(params, state, opt_state, images, gts, weights):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        pred, new_state = model.apply_train(leaves, state, images,
                                            compute_dtype=compute_dtype,
                                            fakequant=fakequant)
        per = torch.mean(torch.square(pred - gts), dim=(1, 2, 3))
        loss = torch.sum(per * weights) / torch.sum(weights)
        keys = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
        updates, opt_state = opt.update(dict(zip(keys, grads)), opt_state)
        with torch.no_grad():
            new_params = dict(zip(keys, torch._foreach_add(
                [params[k].detach() for k in keys], [updates[k] for k in keys])))
        return new_params, new_state, opt_state, loss.detach()

    return step


def train_detector(model, params: dict, state: dict, dataset, hps: dict, *,
                   log_every: int = 1, checkpoint_path: str | None = None,
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

    device_data: keep the whole stacked set (steps, batch, ...) on the card
    and slice it per step; None turns it on when it fits the
    FVY_DEVICE_DATA_BUDGET bytes (default 4e9). Same batches, same order and
    the same update as the streaming path, which prefetches each batch on a
    thread with a pinned upload.

    checkpoint_every: also save params, BN state and Adam state every N
    epochs (a killed run resumes through model_loading). Checkpoints are
    `.pt` with the trainmeta sidecar {"qat": fakequant}.
    """
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import save_checkpoint

    dtype = compute_dtype if compute_dtype is not None else torch.float32
    device = next(iter(params.values())).device
    batch_size = int(hps["batch_size"])
    steps = dataset.steps(batch_size)
    hps["step"] = steps  # the reference's runtime overwrite
    opt = KerasAdam(hps["lr"], hps["beta_1"], hps["beta_2"], hps["decay"])
    opt_state = (coerce_adam_state(init_opt_state) if init_opt_state is not None
                 else opt.init(params))
    opt_state.count = opt_state.count.to(device)
    opt_state.mu = {k: v.to(device) for k, v in opt_state.mu.items()}
    opt_state.nu = {k: v.to(device) for k, v in opt_state.nu.items()}
    step = make_train_step(model, opt, compute_dtype=dtype, fakequant=fakequant)
    # The f32 contract: no TF32 in cuDNN convs or cuBLAS matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def make_batch(i):
        images, gts, weights = _pad_batch(dataset.batch(i, batch_size), batch_size)
        images = torch.from_numpy(images)
        if dtype == torch.bfloat16:
            # The forward casts to bf16 first anyway: half the upload bytes.
            images = images.to(torch.bfloat16)
        return images, torch.from_numpy(gts), torch.from_numpy(weights)

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
    if finalize_bn:
        state = finalize_bn_stats(model, params, state, dataset, batch_size)
    if checkpoint_path:
        save(checkpoint_path)
    return params, state, losses


@torch.no_grad()
def finalize_bn_stats(model, params: dict, state: dict, dataset, batch_size: int, *,
                      max_batches: int | None = None) -> dict:
    """Re-estimate the BN moving statistics over the training set with the
    params frozen (trainer.py:233-266): a train-mode f32 forward with
    momentum 0 per batch (the true remainder, not padded) gives each
    batch's statistics, averaged in float64 on the host, then f32."""
    device = next(iter(params.values())).device
    steps = dataset.steps(batch_size)
    if max_batches is not None:
        steps = min(steps, max_batches)
    sums = None
    for i in range(steps):
        images = torch.from_numpy(dataset.batch(i, batch_size)[0]).to(device)
        _, bstats = model.apply_train(params, state, images, bn_momentum=0.0)
        host = {k: v.cpu().numpy().astype(np.float64) for k, v in bstats.items()}
        sums = host if sums is None else {k: sums[k] + host[k] for k in sums}
    if sums is None:
        return state
    return {k: torch.from_numpy((v / steps).astype(np.float32)).to(device)
            for k, v in sums.items()}


def _write_history(history_path, losses):
    """One JSON line {"step": i, "loss": loss} a step (trainer.py:269-277)."""
    if not history_path:
        return
    with open(history_path, "w") as f:
        for i, loss in enumerate(losses):
            f.write(json.dumps({"step": i, "loss": loss}) + "\n")
