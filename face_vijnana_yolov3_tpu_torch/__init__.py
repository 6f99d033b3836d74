"""face_vijnana_yolov3_tpu_torch — the PyTorch/CUDA port of face_vijnana_yolov3_tpu.

The JAX package beside this one is the reference: every module here is held
against its JAX counterpart by the `tests/test_torch_*.py` parity tests. This
package never imports jax.

What is ported: face detection (f32, bf16 and int8 serving, and
training), face identification (the triplet embedder at f32, bf16 and
int8, device ROI crops, the registry match, the subject DB, the five
`fi_conf` modes and triplet training), the COCO demo, serving artifacts
(`torch.export`) and multi-process data / tensor / spatial parallelism:

models   darknet trunk op-IR + eval/training forwards, face detector (trunk +
         head), face identifier (trunk + dense1 + L2 normalize), int8 quant
core     darknet .weights reader, `.pt` checkpoints + trainmeta sidecar,
         Keras h5 weights in and out, FVYX serving artifacts (export)
ops      letterbox geometry, cv2-faithful resize as matmuls, head decode,
         greedy NMS (hand-written CUDA sweep kernel + plain twin),
         postprocess, int8 conv / residual-block and fused-front kernels
         (also the `fvy::` custom ops of ops/library.py), ROI crops as
         matmuls, registry matching
data     threaded prefetch with pinned-memory device upload, datasets,
         subject-face DB and triplets, seeded synthetic sets
train    Keras Adam, the detector and triplet training loops (one
         process, or data / dense1-tensor parallel over a mesh)
parallel process groups and the ("data", "model") mesh, data-parallel
         serving, height-split detection
evals    the mAP and identification metric harnesses
api      FaceDetectorPipeline, FaceIdentifierPipeline, the `--conf=...`
         CLIs, the evaluate CLI, the export CLI
convert  JAX numpy param trees <-> torch state dicts
kernels  nvcc build + ctypes binding of the CUDA sources under `csrc/`
profile_detect  where the card's time goes in detect_batch (torch.profiler)

Layout: public functions take NHWC images and return the JAX package's
shapes ((B, 13, 13, 6) head, (B, 60, 6) candidates, (B,) counts); convs run
NCHW inside.

Training runs with deterministic algorithms (train/trainer.deterministic),
and `torch.use_deterministic_algorithms` accepts a cuBLAS call only when
CUBLAS_WORKSPACE_CONFIG names a fixed workspace. PyTorch reads the variable
once, at the process's first cuBLAS call, which serving may make before any
training does; so it is set here, unless the caller set it. ":4096:8" is
the 32 MiB that PyTorch gives each cuBLAS handle on Hopper by default, so
serving's cuBLAS calls are the same with it.
"""

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

__version__ = "0.1.0"
