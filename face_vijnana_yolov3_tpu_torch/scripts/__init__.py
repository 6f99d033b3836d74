"""The release loop as tools, each runnable as `python -m
face_vijnana_yolov3_tpu_torch.scripts.<name>`, on the CUDA card unless
given `--device cpu` (without a card and without that flag they raise):

- `train_qat_recipe`: recipe v3 in kill-safe chunks (plain, then a
  fake-quant finetune `--init-from` the plain artifact);
- `select_serving_tail`: the held-out AP50 frontier over the int8 bf16-tail
  candidates, pinned into the checkpoint's trainmeta sidecar;
- `release_ap`: held-out AP50 and mAP at f32, bf16 and int8 as served, each
  AP50 with a bootstrap interval over the val images;
- `synthetic_e2e`, `synthetic_fi_e2e`: the detection and identification
  loops from random init on seeded synthetic data;
- `qat_conv_exactness`: distillation QAT's fake-quant convs against their
  exact integer sums, by conv route.

All but `release_ap` and `qat_conv_exactness` port the JAX repo's scripts of the same names; none
imports anything of it. Their default workdir is `.bench_cache_torch`
(checkpoints are `.pt` files), so the two packages never load each
other's checkpoints.
"""

import os

DEFAULT_WORKDIR = ".bench_cache_torch"


def ckpt_path(workdir: str, name: str) -> str:
    """`<workdir>/<name>.pt`: the JAX scripts name Orbax directories, the
    port's checkpoints are `.pt` files (a name ending in .pt is kept)."""
    return os.path.join(workdir, name if name.endswith(".pt") else name + ".pt")
