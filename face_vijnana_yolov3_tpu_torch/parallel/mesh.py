"""Process groups, the ("data", "model") mesh, and the collectives the
scale-out paths need.

Port of face_vijnana_yolov3_tpu/parallel/mesh.py. JAX runs ONE SPMD
program over a mesh of devices; the port runs one process per card (or
per CPU rank under gloo), joined by `torch.distributed`, and writes the
collectives out:

  data   — batch: rank d of the data axis holds rows [d·B/n, (d+1)·B/n) of
           every global batch; gradients sum over it.
  model  — tensor parallelism for the identifier's dense1 kernel (its
           173,056 input rows split over the axis, train/trainer.py) and
           the image-height split of parallel/spatial.py.

A rank's coordinates: rank = data_index · model_axis + model_index, the
layout of JAX's `devices.reshape(n / model_axis, model_axis)`.

Differentiable collectives (`all_reduce_sum`, `sum_forward`,
`sum_backward`, `all_gather_rows`) carry gradients across ranks, so that a
rank's backward also sees the other ranks' rows where the JAX program's
global reductions did.

`init_distributed` never falls back: a CUDA run uses NCCL or raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     device: torch.device | str | None = None) -> bool:
    """Join the process group; returns whether this is a distributed run.

    A single process with nothing asked for is a no-op (False), as in the
    JAX package (mesh.py:54-72): something is asked for when an argument is
    given, or when torchrun's WORLD_SIZE is in the environment. Then
    `torch.distributed.init_process_group` runs with init method
    `tcp://<coordinator_address>` (else env://: MASTER_ADDR, MASTER_PORT),
    world size `num_processes` (else WORLD_SIZE) and rank `process_id`
    (else RANK). `device` is the card by default: NCCL, with this process's
    card set from LOCAL_RANK (else rank modulo the cards); "cpu" uses gloo.
    There is no fallback from NCCL to gloo.
    """
    explicit = any(v is not None for v in (coordinator_address, num_processes,
                                           process_id))
    if not explicit and "WORLD_SIZE" not in os.environ:
        return False
    if dist.is_initialized():
        return True
    dev = torch.device("cuda" if device is None else device)
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device is visible; pass "
                               "device='cpu' for a gloo group on the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("init_distributed: this torch has no NCCL")
        backend = "nccl"
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 rank % torch.cuda.device_count())))
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: device {dev}: expected cuda or cpu")
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Global rank 0, or a single process: the one that writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def mesh_device() -> torch.device:
    """This rank's device: its card under NCCL, else the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: int | None = None, model_axis: int = 1):
    """DeviceMesh of shape (data = n / model_axis, model = model_axis) over
    every rank of the process group (`init_distributed` first)."""
    n = world_size() if n_devices is None else int(n_devices)
    if n % model_axis != 0:
        raise ValueError(f"{n} devices not divisible by model={model_axis}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed()")
    if n != world_size():
        raise ValueError(f"make_mesh: {n} devices, but the process group has "
                         f"{world_size()} ranks (a mesh spans them all)")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(mesh_device().type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def default_mesh(model_axis: int = 1):
    """The mesh a pipeline trains on: all ranks when the process group is
    up (or a model axis is asked for), else None (one process, no
    collectives)."""
    if dist.is_initialized() or model_axis > 1:
        return make_mesh(model_axis=model_axis)
    return None


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh[axis].size()


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def mesh_key(mesh) -> tuple:
    """What a program key adds for a mesh: ("mesh", its (data, model)
    shape, this rank's (data, model) coordinates); () without a mesh. Every
    rank runs the same sequence of keys, so that each captures and replays
    its collectives in the same order as the others."""
    if mesh is None:
        return ()
    return ("mesh", (axis_size(mesh, "data"), axis_size(mesh, "model")),
            (axis_rank(mesh, "data"), axis_rank(mesh, "model")))


def axis_group(mesh, axis: str):
    """The process group of this rank's `axis` (None without a mesh: no
    collective runs). A one-rank axis keeps its group, so a world of one
    card still runs every collective of the path."""
    return None if mesh is None else mesh.get_group(axis)


# ------------------------------------------------------------------ placement

def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def replicated(tree, mesh):
    """Every tensor of `tree` (nested dicts, lists, tuples) as rank 0 holds
    it, on every rank: a broadcast from global rank 0 into a copy. Other
    leaves are kept as they are. A single process returns `tree`."""
    if mesh is None:
        return tree

    def bcast(t):
        t = t.detach().clone().contiguous()
        dist.broadcast(t, src=0)
        return t

    return _map_tensors(bcast, tree)


def batch_sharded(x: torch.Tensor, mesh) -> torch.Tensor:
    """This data rank's contiguous rows of a global batch x (B, ...)."""
    n = axis_size(mesh, "data")
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} not divisible by the data axis ({n})")
    b = x.shape[0] // n
    d = axis_rank(mesh, "data")
    return x[d * b:(d + 1) * b]


def dense1_rows(mesh, flat_dim: int) -> slice:
    """The rows of the (flat_dim, D) dense1 kernel this model rank holds:
    contiguous, flat_dim / model_axis of them (the port keeps the kernel
    transposed, so they are columns of `dense1.weight`)."""
    m = axis_size(mesh, "model")
    if flat_dim % m:
        raise ValueError(f"dense1 rows {flat_dim} not divisible by model={m}")
    per = flat_dim // m
    i = axis_rank(mesh, "model")
    return slice(i * per, (i + 1) * per)


def shard_identifier_params(mesh, params: dict) -> dict:
    """{key: slice of its last dim this rank holds, or None (whole)}:
    dense1's kernel split over 'model' (JAX P('model', None) on the Keras
    kernel), everything else replicated (mesh.py:102-111)."""
    out = {k: None for k in params}
    if "dense1.weight" in params:
        out["dense1.weight"] = dense1_rows(mesh, params["dense1.weight"].shape[-1])
    return out


def put_tree(tree: dict, shardings: dict, mesh) -> dict:
    """`replicated(tree)` with each tensor cut to its `shardings` slice of
    the last dim (None keeps it whole)."""
    tree = replicated(tree, mesh)
    return {k: v if shardings.get(k) is None else v[..., shardings[k]].contiguous()
            for k, v in tree.items()}


def gather_tree(tree: dict, shardings: dict, mesh) -> dict:
    """Inverse of `put_tree`: every sliced tensor gathered whole over the
    'model' axis (for checkpoints, which hold the full kernel)."""
    group = axis_group(mesh, "model")
    out = {}
    for k, v in tree.items():
        if shardings.get(k) is None:
            out[k] = v
            continue
        parts = [torch.empty_like(v) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, v.contiguous(), group=group)
        out[k] = torch.cat(parts, dim=-1)
    return out


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's x of one shape, concatenated along `dim` in group-rank
    order (no gradient)."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


# ------------------------------------------------------------------ autograd collectives

class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum over the group. Backward: the sum of the cotangents,
    since every rank's loss reads the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumForward(torch.autograd.Function):
    """Forward: the sum over the group. Backward: the cotangent as is (the
    ranks of the group hold one and the same loss)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """Forward: x as is. Backward: the sum of the group's cotangents (each
    rank used its own part of x)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGatherRows(torch.autograd.Function):
    """Forward: every rank's rows concatenated in group-rank order.
    Backward: the summed cotangent of this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return all_gather_cat(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        i = dist.get_rank(ctx.group)
        return g[i * ctx.rows:(i + 1) * ctx.rows], None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllReduceSum.apply(x, group)


def sum_forward(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumForward.apply(x, group)


def sum_backward(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumBackward.apply(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllGatherRows.apply(x, group)


def all_reduce_max_(x: torch.Tensor, group) -> torch.Tensor:
    """In place, no gradient: the elementwise max over the group."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x
