"""Can a CUDA graph hold the collectives of the mesh paths?

The mesh training steps and the data-parallel serving programs capture
their collectives: the differentiable all-reduces of parallel/mesh.py in
the forward and in autograd's backward, the MAX all-reduce of the
fake-quant maxabs, the all_gather of the semi-hard pool and of the DP
results, and the gradient sum. This script joins an NCCL group at world
size 1 (one card), creates its communicator with a broadcast, and then,
each through `core/programs.ProgramCache`:

  all_reduce   one SUM all-reduce, captured and replayed on new inputs;
  max_gather   a MAX all-reduce and an all_gather in one serving program;
  grad_step    a training program (donated carry): forward through
               `mesh.all_reduce_sum` and `mesh.all_gather_rows`, the
               gradient by `torch.autograd.grad` (its collectives run in
               autograd's backward) summed over the group, an update.

Each is held `torch.equal` to the same function run eagerly on the same
inputs, over three replays with fresh inputs.

Usage: python -m face_vijnana_yolov3_tpu_torch.scripts.probe_nccl_capture
       [--port 29533]

Prints one JSON object: the torch and NCCL versions and, per case, "ok"
or the error text. Exits 1 when a case failed.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

import torch
import torch.distributed as dist


def _cases():
    from face_vijnana_yolov3_tpu_torch.parallel import mesh as mesh_lib

    group = dist.group.WORLD

    def all_reduce(x):
        y = x * 2.0
        dist.all_reduce(y, group=group)
        return y

    def max_gather(x):
        m = mesh_lib.all_reduce_max_(x.abs().amax(dim=0), group)
        return mesh_lib.all_gather_cat(x / m, group)

    def grad_step(w, x):
        leaf = w.detach().requires_grad_(True)
        h = mesh_lib.all_reduce_sum(x @ leaf, group)
        rows = mesh_lib.all_gather_rows(torch.tanh(h), group)
        loss = (rows * rows).sum()
        (g,) = torch.autograd.grad(loss, [leaf])
        dist.all_reduce(g, group=group)
        return leaf.detach() - 1e-3 * g, loss.detach()

    return {"all_reduce": (all_reduce, 0, lambda d: (torch.randn(1024, device=d),)),
            "max_gather": (max_gather, 0, lambda d: (torch.randn(64, 32, device=d),)),
            "grad_step": (grad_step, 1, lambda d: (torch.randn(32, 16, device=d),
                                                   torch.randn(8, 32, device=d)))}


def main(argv=None) -> int:
    from face_vijnana_yolov3_tpu_torch.core.programs import ProgramCache
    from face_vijnana_yolov3_tpu_torch.parallel import mesh as mesh_lib

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=29533)
    args = ap.parse_args(argv)
    mesh_lib.init_distributed(f"localhost:{args.port}", 1, 0)
    dev = mesh_lib.mesh_device()
    torch.manual_seed(0)
    # The communicator exists before any capture: NCCL cannot create it
    # inside a graph.
    dist.broadcast(torch.zeros(1, device=dev), src=0)
    rec = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "nccl": ".".join(map(str, torch.cuda.nccl.version())), "cases": {}}
    ok = True
    for name, (fn, donate, make) in _cases().items():
        try:
            train = donate > 0
            programs = ProgramCache(dev, train=train)
            carry = None
            for rep in range(4):
                inputs = make(dev)
                if carry is not None:
                    inputs = (carry, *inputs[donate:])
                want = fn(*(x.clone() for x in inputs))
                got = programs.run((name,), fn, *inputs, donate=donate)
                want = want if isinstance(want, tuple) else (want,)
                got = got if isinstance(got, tuple) else (got,)
                if not all(torch.equal(a, b) for a, b in zip(want, got, strict=True)):
                    raise AssertionError(f"replay {rep} != eager")
                if train:
                    carry = got[0]
            rec["cases"][name] = "ok"
        except Exception as e:  # noqa: BLE001 - every case is reported
            ok = False
            rec["cases"][name] = f"{type(e).__name__}: {e}"
            traceback.print_exc()
    print(json.dumps(rec))
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
