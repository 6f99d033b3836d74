"""The PyTorch port imports neither jax nor any module of the JAX package.

conftest.py has already imported jax into this process, so the runtime check
runs in a fresh interpreter: import the port, build a small detector and run
f32, bf16 and int8 `detect_batch` on the CPU (the int8 one calibrates and runs
the int8 convs and the fused residual blocks), the fused-front trunk
(ops/front_fused.py) and one fake-quant training step, import the training,
dataset, Keras-h5, native-loader and mAP modules, then assert that neither `jax`
nor `face_vijnana_yolov3_tpu` is in sys.modules. The static check reads
every source of the package and chip_smoke.py: no import of either, and no
allow-list.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import face_vijnana_yolov3_tpu_torch

PACKAGE = Path(face_vijnana_yolov3_tpu_torch.__file__).parent
CHIP_SMOKE = PACKAGE.parent / "chip_smoke.py"

_CHILD = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(2)
import face_vijnana_yolov3_tpu_torch
from face_vijnana_yolov3_tpu_torch import ablate_kernels, kernels, profile_detect
from face_vijnana_yolov3_tpu_torch.api.config import FdConf
from face_vijnana_yolov3_tpu_torch.api.face_detection import FaceDetectorPipeline, main
from face_vijnana_yolov3_tpu_torch.core import checkpoints, weights
from face_vijnana_yolov3_tpu_torch.ops.front_fused import apply_graph_folded_front
from face_vijnana_yolov3_tpu_torch.utils import drawing, io
from face_vijnana_yolov3_tpu_torch.api import evaluate
from face_vijnana_yolov3_tpu_torch.core import keras_import
from face_vijnana_yolov3_tpu_torch.data import native_loader, synthetic, uccs
from face_vijnana_yolov3_tpu_torch.evals import detection
from face_vijnana_yolov3_tpu_torch.models.darknet import split_state_dict
from face_vijnana_yolov3_tpu_torch.train import optimizer, trainer

conf = FdConf(weights_path="does_not_exist.weights")
conf.nn_arch.image_size = 64
conf.int8_pallas_blocks = True
x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
for precision in ("float32", "bfloat16", "int8"):
    fd = FaceDetectorPipeline(conf, precision=precision, device="cpu")
    cands, counts = fd.detect_batch(x)
    assert cands.shape == (2, 4, 6) and counts.shape == (2,), (cands.shape, counts.shape)
trunk = apply_graph_folded_front(fd.model.fold(), torch.from_numpy(x), fd.model.ops)
assert trunk["trunk"].shape == (2, 2, 2, 1024), trunk["trunk"].shape
params, state = split_state_dict(fd.model.state_dict())
opt = optimizer.KerasAdam(1e-3)
step = trainer.make_train_step(fd.model, opt, fakequant=True)
gts = torch.zeros((2, 2, 2, 6))
params, state, _, loss = step(params, state, opt.init(params), torch.from_numpy(x), gts,
                              torch.ones(2))
assert torch.isfinite(loss), loss
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "face_vijnana_yolov3_tpu"))
assert not leaked, leaked
print("OK")
"""


def test_port_runs_without_importing_jax():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(PACKAGE.parent)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_no_jax_import_in_package_sources():
    sources = [*PACKAGE.rglob("*.py"), CHIP_SMOKE]
    assert CHIP_SMOKE.exists()
    for path in sources:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top != "jax", f"{path}: imports {name}"
            assert top != "face_vijnana_yolov3_tpu", f"{path}: imports {name}"
