"""The PyTorch port imports neither jax nor any module of the JAX package.

conftest.py has already imported jax into this process, so the runtime check
runs in a fresh interpreter: import the port, build a small detector and run
f32, bf16 and int8 `detect_batch` on the CPU (the int8 one calibrates and runs
the int8 convs and the fused residual blocks), the fused-front trunk
(ops/front_fused.py) and one fake-quant training step, embed with a small
identifier at f32, bf16 and int8, crop ROIs on the device path and match
them against a registry, run the full YOLOv3 at int8 through the COCO
postprocess and the reconstruction decoder, export the int8 detector
through the `fvy::` custom ops and load it back, serve it with
`detect_quant_dp` and the f32 head with `detect_spatial` (one process),
import the training, dataset, Keras-h5, native-loader, mAP, subject-DB,
identification, COCO demo, box selection, profiling, export CLI and mesh
modules, then assert that neither `jax`
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
from face_vijnana_yolov3_tpu_torch.api import face_identification
from face_vijnana_yolov3_tpu_torch.data import facedb
from face_vijnana_yolov3_tpu_torch.evals import identification
from face_vijnana_yolov3_tpu_torch.models.identifier import FaceIdentifierModel
from face_vijnana_yolov3_tpu_torch.ops import roi
from face_vijnana_yolov3_tpu_torch.ops.similarity import match_embeddings
from face_vijnana_yolov3_tpu_torch.api import yolov3_detect
from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
from face_vijnana_yolov3_tpu_torch.models import darknet, recon
from face_vijnana_yolov3_tpu_torch.ops.postprocess import coco_postprocess
from face_vijnana_yolov3_tpu_torch.utils import box_select, profiling
from face_vijnana_yolov3_tpu_torch.ops import library
from face_vijnana_yolov3_tpu_torch.core import export as fvy_export
from face_vijnana_yolov3_tpu_torch.api import export_cli
from face_vijnana_yolov3_tpu_torch.parallel import mesh, serving, spatial
import os.path
import tempfile

conf = FdConf(weights_path="does_not_exist.weights")
conf.nn_arch.image_size = 64
conf.int8_pallas_blocks = True
x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
for precision in ("float32", "bfloat16", "int8"):
    fd = FaceDetectorPipeline(conf, precision=precision, device="cpu")
    cands, counts = fd.detect_batch(x)
    assert cands.shape == (2, 4, 6) and counts.shape == (2,), (cands.shape, counts.shape)
with tempfile.TemporaryDirectory() as d:
    fvy_export.export_detector(fd, os.path.join(d, "int8.fvyx"))
    got, _ = fvy_export.load_artifact(os.path.join(d, "int8.fvyx"))(x)
    assert np.array_equal(got.numpy(), cands)
head = serving.detect_quant_dp(fd.model, None, fd._qparams, fused_blocks=True)(x)
sp = spatial.detect_spatial(fd.model, None, compute_dtype=torch.float32)(fd.model.fold(), x)
assert head.shape == sp.shape == (2, 2, 2, 6), (head.shape, sp.shape)
trunk = apply_graph_folded_front(fd.model.fold(), torch.from_numpy(x), fd.model.ops)
assert trunk["trunk"].shape == (2, 2, 2, 1024), trunk["trunk"].shape
params, state = split_state_dict(fd.model.state_dict())
opt = optimizer.KerasAdam(1e-3)
step = trainer.make_train_step(fd.model, opt, fakequant=True)
gts = torch.zeros((2, 2, 2, 6))
params, state, _, loss = step(params, state, opt.init(params), torch.from_numpy(x), gts,
                              torch.ones(2))
assert torch.isfinite(loss), loss
fim = FaceIdentifierModel(image_size=64, dense1_dim=8, device="cpu")
xt = torch.from_numpy(x)
embs = [fim.embed(xt), fim.embed_folded(fim.fold(), xt, f32_front_blocks=2),
        fim.embed_quant(fim.quantize(fim.fold(), xt), xt)]
assert all(e.shape == (2, 8) for e in embs), [e.shape for e in embs]
img = (x[0] * 255).astype(np.uint8)
keep, wins = roi.build_roi_windows(np.array([[5.0, 5.0, 40.0, 30.0, 0.9]]), 64, 64)
org = np.array([[0, 0, 0]], np.int32)
crops = roi.roi_letterbox_device_windowed(
    torch.from_numpy(img[None]), torch.from_numpy(org),
    *(torch.from_numpy(a) for a in roi.stack_roi_taps(wins, 64, org[:, 1:])),
    window_h=64, window_w=64)
idx, dist = match_embeddings(fim.embed(crops), embs[0])
assert idx.shape == (1,) and bool(torch.isfinite(dist).all())
yops = darknet.yolov3_graph()
ysd = params_from_jax(*darknet.init_graph_params(yops, 0))
x1 = torch.from_numpy(x[:1])
heads = yolov3_detect.coco_forward(ysd, "int8", "cpu", x_calib=x1)(x1)
boxes, obj, classes, valid = coco_postprocess(tuple(h[0] for h in heads), 64, 64,
                                              0.0, 0.45, net_h=64, net_w=64)
assert classes.shape == (100, 80), classes.shape
rm = recon.FaceReconstructionModel(image_size=64, dense1_dim=8, device="cpu")
rm.load_state_dict(rm.init_state_dict(fim.state_dict()))
assert rm(embs[0]).shape == (2, 64, 64, 3)
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
