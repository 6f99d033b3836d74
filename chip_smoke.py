"""Smoke run of the PyTorch port on one CUDA card: build, check, serve, time.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
(the kernels are built for sm_90a) and the CUDA toolkit. Phases, each of
which raises on failure (exit code != 0):

1. device   — the card's name, power limit and TF32 flags;
2. build    — nvcc builds the port's four CUDA kernels from csrc/;
3. kernels  — each kernel vs its plain PyTorch version on the card,
              `torch.equal` required: the NMS sweep at B 1, 32, 128 x N 1,
              31, 32, 33, 169, 1024 (float, integer and degenerate boxes;
              non-finite boxes, absent and tied scores at N=169), and at B
              1, 32 x N 1,025, 1,089, 1,600, 4,096 (every kind; the mask in
              a device-memory workspace);
              conv_int8 at every conv_int8 shape of the int8 trunk at 416²
              (b=8 and b=1, with and without skip, k 1 and 3, stride 1 and
              2), at each (cin, cout, k, stride) on a ragged 11x19 input at
              b=3, plus rectangular inputs; block_int8 at the three residual
              stages (b=32 and b=1) and on 11x19 at b=3. The bf16 fused front
              (fused_front) at 416² b=1, 8, 32, 100² (ragged tiles), 98²
              (the loader without TMA) and b=65,537 at 2² and 4², within
              one bf16 step on at most 0.1 % of the elements (FRONT_*). Then
              each is timed with CUDA events at the main path's shapes (one
              416² trunk at b=32 for the int8 kernels, with the blocks on,
              and conv_int8 again over the 52 convs with them off, each call
              and its `_int_mm` yardstick as device time of a replayed CUDA
              graph; the NMS sweep at B=128 and B=32 (and at N 1,089 and
              1,600, B=32) and the front at b=32
              the same way, with per-call events beside them)
              beside its plain version, its bound and a library yardstick:
              one `torch._int_mm` per int8 GEMM (product only: the im2col
              the library would need is not counted), the two cuDNN bf16
              convs for the front (products only), and the port's stock
              depth-0 bf16 front;
4. slice    — f32: the CLI (`api.face_detection.main`, test mode) serves 8
              seeded JPEGs at 416², batch 4, with seeded random weights
              from a .pt checkpoint; then the device letterbox, the card's
              head vs the CPU's, and the kernel postprocess vs the plain one;
5. int8     — FaceDetectorPipeline(precision="int8", int8_pallas_blocks on)
              serves the same JPEGs in test mode from a checkpoint whose
              trainmeta pins int8_tail 3 (seeded random kernels, seeded BN
              statistics); every kernel must launch and the pin must hold.
              Then, at full int8: the trunk with the fused blocks on equals
              the one with them off, and the card's trunk equals the CPU's
              plain one at 416² (an integer program: any difference is a
              kernel fault); the bf16 heads within a stated tolerance;
6. bf16     — FaceDetectorPipeline(precision="bfloat16", bf16_f32_front
              "auto") serves the same JPEGs in test mode (batches of 4: the
              guard probe defers), then the probe runs on 32 letterboxed
              images; then the 416² b=32 detection program through
              apply_graph_folded_front (kernel C, the bf16 trunk from op 2,
              the bf16 head, face_postprocess_batch), whose head must lie
              within 2e-2 of max |head| of the pipeline's depth-0 head;
              fused_front and nms_sweep must launch;
7. timing   — int8 detect_batch img/s at b=32 and b=128 (full int8, blocks
              on), the trunk alone with the blocks on and off, calibration
              seconds, f32 detect_batch at b=8 and b=32, bf16 detect_batch
              at b=32 and b=128 at guard depths 2 and 0, and the bf16
              forward at b=32 with the stock front and with the fused one;
8. serve    — f32 test mode at image_size 1,056 (N = 1,089: the NMS mask in
              a device-memory workspace) on the card and on the CPU, CSVs
              compared (SERVE_*);
9. calib    — the quantization path's divisions by 127 on the same
              host-made inputs, card vs CPU, torch.equal: the "auto" and
              msegrid candidate grids, `_act_fq`'s scale and `_weight_fq`'s
              kernel (with the count of scales the parent's `/ 127.0`
              would put one ulp elsewhere on each device); msegrid
              calibration and PTQ bias correction at 416² on the card vs
              the CPU port (CALIB_*); in phase 17's process, "auto" on
              phase 14's checkpoint card vs CPU (printed, not gated);
10. train   — one f32 train step at b2 416², card vs CPU port (STEP_*);
              train_detector on a seeded synthetic set (TRAIN_*): f32 b32
              through the CLI's mode=train (TF32 off), bf16 mixed at b32 and
              b128, fake-quant QAT at b32, each loss falling; train_img_s
              and peak memory (f32 b32, bf16 b128) with a profiler split of
              a step; the trained checkpoint served at f32 and int8 (A0, A
              and B must launch), evaluate + the mAP harness (AP printed,
              not gated); which JPEG decoder the device-letterbox path ran;
11. identify — face identification at 416² (FI_*): the seeded synthetic
              identity tree through the CLI (data, fid_db + the registry,
              test at f32 with host crops and with device_roi), hand-made
              boxes through the f32, int8 (nested int8 detector with the
              block kernel) and bf16 pipelines: the main path, whose launch
              counts (B, A0 and A must move) go to `launches_identify`;
              then the card's identify rows vs the CPU port's, device ROI
              crops vs host crops, the int8 embed trunk card vs CPU bit for
              bit on the same qparams, the bf16 embed's guard; embed img/s
              at 64 crops (f32, bf16, int8) and ms per identified chunk on
              the device-ROI path; one f32 triplet step card vs CPU, triplet
              training (bf16 b32, f32 b8 with the loss falling; semi_hard),
              triplets/s and peak memory, held-out top-1 (not gated); the
              int8 CLI test run again from the same seeds and file order
              must write the same rows;
12. coco    — the COCO demo on the full YOLOv3-416 (COCO_*): a seeded
              darknet yolov3.weights, the `-w` CLI (api.yolov3_detect.main)
              at f32, bf16 and int8 on a landscape and a portrait JPEG,
              `-s`/`-l` where h5py is installed, the legacy `--mode test`
              CLI (without h5py: legacy_args_to_conf on a .pt), FI
              reconstruct of RECON_IDS ids at 416²: the main path, whose
              launch counts (B, A0 and A must move) go to `launches_coco`;
              then A0 vs plain at every conv shape the face trunk lacks
              (the 255-channel linear heads, the 768/384-channel concat
              inputs), A at b=1, B on the (80, 256) class batch (and with
              infinite and zero-area boxes), the int8 heads card vs CPU
              with the blocks on and off (bit-identical), the f32 heads
              card vs CPU (HEAD_TOL), reconstruct card vs CPU (RECON_TOL);
              detect_coco ms per image at each precision on a
              device-resident input, its kernel launches per int8 image
              (35 A0, 20 A, 1 B), B at (80, 256) and reconstruct ms;
              then `YOLOV3` at f32 and bf16 over the two JPEGs twice and a
              second image of the first one's shape, which must reuse its
              program (B must move under replay: `launches_coco_replay`),
              each replay torch.equal to the eager program, ms an image
              eager vs replay and the busy shares.
13. deploy  — scale-out and deploy at world size 1 over NCCL and the
              exported artifacts in a fresh process (DEPLOY_*;
              `launches_deploy`), the export CLI, the two routes timed; the
              mesh paths' programs with their collectives captured: the DP
              int8 detect at b32 (A0, A and B must move:
              `launches_deploy_dp_replay`, added to `launches_deploy`) and
              a DP ROI identify chunk, replay vs eager torch.equal; the
              detector step at f32 and fake-quant b16 and the semi-hard
              triplet step at b8 with the mesh, eager vs replay over 4
              steps torch.equal on every carry tensor and loss; ms a call
              and a step eager vs replay;
14. release — the release loop through its tools (RELEASE_*): recipe v3
              at 416² on a seeded 160/40 set (plain epochs at 1e-3, then a
              fake-quant finetune --init-from them at 1e-4; epochs reached,
              the sidecar's qat flag, the loss falling in each phase),
              select_serving_tail over tails (0, 3) (the pin written equals
              the one returned, A0 and B launch in its AP passes),
              release_ap (f32, bf16 with the probed guard, int8 at the pin,
              which a fresh int8 pipeline must serve; AP50 with bootstrap
              95 % intervals, not gated), the pinned int8 served with the
              fused blocks on and off (equal CSVs, A launches),
              int8_error_profile at the pin (one finite, non-negative row
              per int8 conv), synthetic_fi_e2e (the triplet loss falling;
              top-1 and VAL/FAR printed): the main path, whose launch
              counts go to `launches_release` (B, A0 and A must move).
15. programs — the captured serving programs (core/programs.py; PROGRAM_*),
              in a fresh process (`programs_phase_fresh`): detect_batch
              and detect_batch_fused (a full chunk and a short last chunk
              padded to the batch, which must reuse the full chunk's
              program) at f32 b8, bf16 guard 2 b32 and int8 blocks on b32,
              each replay against the eager `_detect_program` on the same
              inputs (int8 torch.equal; f32, bf16 within their rules); an
              f32 device-ROI identify chunk of 17 crops (the programs of 16
              and 1) against the eager program functions (equal rows); a
              capture that calls `.item()` must raise ProgramError; eager
              vs replay ms a call and the device busy share of each;
              launches under replay go to `launches_programs` and must
              equal the kernels a profiler trace of the replays names (B,
              A0 and A must move). Every serving call of the earlier
              phases replays captured programs as well.
16. modes   — the two serving modes taken over last (MODES_*), in a fresh
              process (`modes_phase_fresh`) on phase 14's checkpoint and val
              set: distillation QAT (int8_qat_steps, blocks on; calibrated
              on 32 letterboxed training images, then test mode on the val
              JPEGs), PTQ int8, the int8 front guard (bf16_front_mode "int8")
              at depths 2 and 1 and the f32 guard at 2 in test mode, the FI
              bf16 embed with the int8 guard on 64 crops: the main path,
              whose launch counts (B, A0 and A must move) go to
              `launches_modes`; then the refined int8 trunk card vs CPU
              (torch.equal), the fake-quant head vs the served one, head MSE
              against the f32 teacher before and after QAT, the guard's
              int8 front rows card vs CPU (torch.equal) and its head,
              detect_batch ms at b32 beside the f32 guard, the FI embed card
              vs CPU and img/s beside the plain bf16 embed, and held-out
              AP50 of the four served CSVs (printed, not gated).
17. train-programs — the captured training programs (TP_*; core/programs.py
              with train=True, train/trainer.program_step), in a fresh
              process (`train_programs_phase_fresh`) on phase 14's set and
              checkpoint, at 416² and full width: eager vs replay over 8
              steps, torch.equal on every param, BN and Adam tensor and
              every loss, for the detector step at f32 b16, fake-quant b16
              and bf16 b32, the semi-hard triplet step at b8 and
              distillation QAT, each one captured graph; two seeded
              train_detector runs (2 epochs at b16) must end on equal
              checkpoints with deterministic algorithms (the differing
              tensors without them are printed, not gated); train_img_s
              eager vs replay with deterministic algorithms on and off
              (f32 b16, f32 b32, fake-quant b16, bf16 b128) with peak
              memory, the busy share at f32 b16, triplets/s at bf16 b32,
              distillation s a step; `finalize_bn_stats` through its
              programs (one per batch shape) torch.equal to the eager
              forwards, seconds of each. The training steps reach no
              kernel of the port (`launches_train_programs`: 0); the
              serving phases above launch and check all four.

The last lines are the kernels' JSON record, the card's name and power limit
as nvidia-smi reports them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import importlib.util
import io
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from PIL import Image

SEED = 0
DEVICE = "cuda"
IMAGE_SIZE = 416
F32_TIMING_BATCHES = (8, 32)
INT8_TIMING_BATCHES = (32, 128)
BF16_TIMING_BATCHES = (32, 128)
BF16_DEPTHS = (2, 0)
KERNEL_B, KERNEL_N = 128, 169  # nms_sweep timing; also at NMS_TIMING_B2
NMS_TIMING_B2 = 32  # the detect_batch b32 shape
NMS_CHECK_B = (1, 32, 128)  # nms_sweep vs plain: every batch at every N
NMS_CHECK_N = (1, 31, 32, 33, 169, 1024)
CONV_CHECK_B = 8  # conv_int8 vs plain
RAGGED_HW = (11, 19)  # ragged kernel checks at b=3
TRUNK_B = 32  # int8 kernel timings: one trunk at this batch
# fused_front vs plain: (batch, size); 416² at b1 (fewer tiles than SMs), b8
# and b32 (many tiles a persistent block), 100² (ragged tiles), 98² (S % 4
# == 2: the loader without TMA), and a batch above 65,535 at the smallest S
# (2, the loader without TMA) and the smallest TMA one (4)
FRONT_CHECKS = ((1, 416), (8, 416), (32, 416), (3, 100), (2, 98), (65537, 2), (65537, 4))
FRONT_B = 32  # fused_front timing and the bf16 detection program
# Card vs CPU head: cuDNN and the CPU sum each conv in another order, and
# cuDNN may pick Winograd/FFT algorithms for f32, whose rounding differs more.
HEAD_TOL = 1e-4
# The int8 path's bf16 head, card vs CPU, on the same int8 trunk output: the
# two bf16 convs round their f32 sums to bf16 at other places, one bf16 step
# (2^-8 relative) and its effect on the bias add; relative to max |head|.
INT8_HEAD_TOL = 2e-2
# Full int8 (bf16 head) vs the folded f32 program, head NRMSE (the default
# score of models/quant.quantize_autotail) on seeded random weights at 416².
INT8_NRMSE_TOL = 0.1
# fused_front vs its plain twin: both add the bias to an f32 sum taken in
# another order, so a sum next to a bf16 rounding boundary may round the
# other way, in conv_0's output (then carried through conv_1) or in conv_1's:
# max |diff| within one bf16 step at the top of the range (2^-7 of max
# |ref|), on at most 0.1 % of the elements (tests/test_torch_front_fused.py).
FRONT_STEP = 2.0 ** -7
FRONT_MAX_FRACTION = 1e-3
# The fused-front detection head vs the stock depth-0 bf16 head: the two
# fronts round at other places (bias before or after the bf16 rounding), and
# 50 bf16 convs follow; test_torch_folded.py's bf16 bound.
BF16_HEAD_TOL = 2e-2
# Matmul letterbox vs cv2 on the same f32 pixels: f32 rounding only. (cv2 on
# the host path's f64 pixels differs by up to 7e-5 at 1280 wide, in the JAX
# package too: cv2 takes another coefficient path for 64F images.)
LETTERBOX_TOL = 1e-5
# nms_sweep above the shared-memory bound: N = (image_size / 32)^2 > 1024
# from image_size 1,056 up; checked at every B x N, timed at NMS_TIMING_B2.
NMS_LARGE_N = (1025, 1089, 1600, 4096)
NMS_LARGE_B = (1, 32)
NMS_LARGE_TIMED = (1089, 1600)
# [serve]: f32 test mode at 1,056² on the card and the CPU. Scores: the
# card's head is within HEAD_TOL of the CPU's, and score = sigmoid(h0) *
# sigmoid(h5) moves at most 1/4 per unit of each logit. Boxes: a coordinate
# is an integer pixel of a decoded head, so a head an ULP apart may cross a
# pixel boundary on a few rows: one decoded pixel, max(h, w) / 1,056
# original pixels (in one H100 run, one row of 240 at 1920 wide crossed
# 1.82 px, its score 9.5e-7 apart).
SERVE_LARGE = 1056
SERVE_SCORE_TOL = 0.5 * HEAD_TOL
SERVE_BOX_EXACT = 0.98
# [calib]: msegrid scales from f32 forwards on two devices (convs summed in
# another order): the calibrations' rtol of tests/test_torch_quant.py. Bias
# correction on the same scales: its means of (f32 - int8) differ by the f32
# convs' rounding, and a requant that such a difference moves by one step
# spreads through the later means: each conv's biases within a tenth of its
# largest correction (H100 at 416², 2 images: 0.043, 1.2e-4 absolute).
CALIB_IMAGES = 2
CALIB_SCALE_RTOL = 1e-4
CALIB_BIAS_FRACTION = 0.1
# [train]: the seeded synthetic set at 416², runs (label, precision,
# fake-quant, batch); b128 is the JAX package's train_img_s batch.
TRAIN_IMAGES, VAL_IMAGES = 128, 32
TRAIN_SOURCE_SIZE = 416  # the synthetic JPEGs' side (disks of radius 24-55)
TRAIN_EPOCHS = 4
TRAIN_LR = 1e-4  # FdHps.lr; 1e-3 overshoots in the first epochs from a random init
TRAIN_RUNS = (("f32", "float32", False, 32), ("bf16", "bfloat16", False, 32),
              ("bf16_b128", "bfloat16", False, 128), ("qat", "float32", True, 32))
TRAIN_TIMING_STEPS = 8
# train_img_s: (label, dtype, batch) in order; a label already timed is
# skipped, so bf16 b64 runs only when b128 does not fit the card.
TRAIN_TIMING_RUNS = (("f32", torch.float32, 32), ("bf16", torch.bfloat16, 128),
                     ("bf16", torch.bfloat16, 64))
# One f32 step, card vs CPU port: tests/test_torch_train.py's full-trunk
# bounds (gradients 5e-3 of their norm, each param 0.1: BN over few
# samples and leaky kinks), loss and BN statistics 1e-4 (cuDNN may pick
# Winograd or FFT algorithms for f32 convs, whose rounding differs more).
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = 5e-3
STEP_PARAM_GRAD_TOL = 0.1
STEP_STATE_TOL = 1e-4
# [identify]: the seeded synthetic identity tree (416² images, faces of side
# 90-199), FI_SUBJECTS subjects x FI_TRAIN_PER_SUBJ training faces, and
# FI_HOLD_PER_SUBJ held out; sim_th 2.0, the largest L2 distance between
# unit vectors, so that every ROI writes a row.
FI_SUBJECTS, FI_TRAIN_PER_SUBJ, FI_HOLD_PER_SUBJ = 8, 4, 2
FI_SIM_TH = 2.0
FI_ROI_IMAGES = 4  # hand-made boxes on this many images, FI_ROI_BOXES each
FI_ROI_BOXES = 6
FI_EMBED_B = 64  # embed img/s at this many crops (the JAX package's largest bucket)
FI_INT8_CHECK_B = 4  # int8 embed trunk, card vs CPU plain path
# Card vs CPU f32 embeddings: cuDNN and the CPU sum each conv in another
# order (HEAD_TOL's reason); a registry distance moves by at most the sum of
# the two embeddings' differences. A card choice of registry row counts as
# equal when its CPU distance is within FI_DIST_TOL of the CPU minimum (a tie).
FI_DIST_TOL = 1e-4
# Device ROI crops vs cv2's cubic letterbox of the same crops as f32 pixels:
# the f32 rule of tests/test_roi.py (3.6e-7 measured on the CPU at 416²).
# The host path letterboxes f64 pixels (crop / 255), where cv2 takes
# another coefficient path: 1.2e-5 from the JAX package's device crops at
# 416² on the CPU, 7e-5 at 1280 wide (README); that gap within FI_CROP_F64_TOL.
FI_CROP_TOL = 3e-6
FI_CROP_F64_TOL = 1e-4
# Triplet training runs (label, precision, mining, batch, epochs), lr 1e-4.
FI_TRAIN_RUNS = (("bf16", "bfloat16", "random", 32, 6), ("f32", "float32", "random", 8, 3),
                 ("semi_hard", "float32", "semi_hard", 16, 1))
FI_TRAIN_LR = 1e-4
FI_TIMING_STEPS = 6
# One f32 triplet step at b2 (6 images), card vs CPU port: the loss within
# 1e-4 abs (a difference of distances between unit vectors, each within
# the card-vs-CPU embedding error) and the gradients within STEP_GRAD_TOL
# of their norm.
FI_STEP_LOSS_ATOL = 1e-4
# [coco]: the COCO demo (api/yolov3_detect) on the full published YOLOv3-416
# (75 convs, three 255-channel heads), seeded random weights with seeded BN
# statistics and head biases, written as a darknet yolov3.weights; a
# landscape and a portrait JPEG ((h, w): the two branches of the letterbox
# geometry, the portrait one through the reference's `new_h = net_w`).
COCO_SIZE = 416
COCO_JPEGS = ((480, 640), (640, 360))
COCO_PRECISIONS = ("float32", "bfloat16", "int8")
COCO_TIMING_REPS = 10
COCO_NMS_TH = 0.45  # the CLI's default
RECON_IDS = 4
# reconstruct at 416², card vs CPU: 72 transposed convs (cuDNN, TF32 off)
# and the channel l2norms summed in another order; HEAD_TOL's reason,
# relative to max |output|.
RECON_TOL = 1e-4
# mode=fid_db writes the reference's HDF5 (subject_facial_ids.h5) through
# h5py, which a machine may lack; then the registry alone embeds the same
# subject faces.
HAVE_H5PY = importlib.util.find_spec("h5py") is not None
# [deploy]: the exported artifacts, loaded in a fresh process, at these
# batches (traced at 2: no 0/1 specialisation), and the timing batches of
# the exported program against the eager `_detect` (int8, f32) and of the
# two routes to the kernels (the dispatcher's fvy:: ops or the direct call).
DEPLOY_BATCHES = (1, 3, 32)
DEPLOY_TIMING = (("int8", 32), ("float32", 8))
ROUTE_REPS = 10
DEPLOY_TRAIN_LR = 1e-4
# The mesh paths' programs at world size 1 (NCCL captured into the graphs):
# the DP int8 detect batch, the DP ROI identify chunk's crops, the mesh
# training steps (detector f32 and fake-quant at DEPLOY_MESH_B, semi-hard
# triplets at DEPLOY_MESH_TRIPLET_B), eager vs replay over DEPLOY_MESH_STEPS.
DEPLOY_DP_B = 32
DEPLOY_ROI_BOXES = 16
DEPLOY_MESH_B, DEPLOY_MESH_TRIPLET_B, DEPLOY_MESH_STEPS = 16, 8, 4
# [release]: recipe v3 at full width and reduced scale (a seeded set of
# RELEASE_TRAIN/RELEASE_VAL 416² JPEGs, RELEASE_PLAIN plain epochs then
# RELEASE_FT fake-quant epochs at 1e-4), the tail pinned over RELEASE_TAILS,
# held-out APs with a bootstrap over RELEASE_RESAMPLES draws of the val
# images, int8_error_profile on RELEASE_PROFILE_IMAGES val images, and the
# FI loop at RELEASE_FI_SUBJECTS subjects for RELEASE_FI_EPOCHS epochs.
RELEASE_TRAIN, RELEASE_VAL = 160, 40
RELEASE_PLAIN, RELEASE_FT = 12, 4
RELEASE_TAILS = (0, 3)
RELEASE_RESAMPLES = 200
RELEASE_PROFILE_IMAGES = 8
RELEASE_FI_SUBJECTS, RELEASE_FI_EPOCHS = 6, 4
# [programs]: the captured serving programs (core/programs.py) against the
# eager functions they capture, at (label, precision, batch, bf16 guard
# depth); staged uint8 frames of two sizes in one 512x640 staging bucket (so
# every chunk has two geometries), a short last chunk of PROGRAM_SHORT real
# frames padded to the batch; an identify chunk of PROGRAM_ROI_BOXES crops;
# each time over PROGRAM_REPS calls, the busy share over PROGRAM_BUSY_REPS
# under torch.profiler. f32 candidates
# are held to phase 8's rule (SERVE_*), bf16 to the bf16-head rule of
# tests/test_torch_int8_pipeline.py (box edges within one letterbox pixel,
# scores within 1e-2), int8 to torch.equal.
PROGRAM_RUNS = (("f32", "float32", 8, None), ("bf16", "bfloat16", 32, 2),
                ("int8", "int8", 32, None))
PROGRAM_FRAMES = ((480, 640), (456, 608))
PROGRAM_SHORT = 3
PROGRAM_ROI_BOXES = (4, 4, 4, 5)  # boxes on each frame: 17 crops, pieces of 16 and 1
PROGRAM_REPS, PROGRAM_BUSY_REPS = 10, 5
PROGRAM_BF16_BOX_TOL, PROGRAM_BF16_SCORE_TOL = 1.0, 1e-2
# [modes]: the two serving modes the port took over last (phase 16), on phase
# 14's checkpoint and val set: distillation QAT for MODES_QAT_STEPS steps
# (calibrated on MODES_CALIB letterboxed training images, head MSE also on
# MODES_HELD val images), the int8 front guard at MODES_DEPTHS, detect_batch
# timed at MODES_TIMING_B, the FI embed of MODES_FI_CROPS crops. Card vs CPU
# on MODES_CPU_B images (MODES_FI_CPU crops): the CPU runs the bf16 tail at
# 416², which is slow there. The fake-quant head (f32 head conv on the
# fake-quant trunk) vs the served int8 head (bf16 head conv on the int8
# trunk): the bf16 head's rule INT8_HEAD_TOL, since the two trunks differ
# only where an f32 sum passes 2^24: every fake-quant conv equal to its
# exact sum wherever Σ|x|·|k| ≤ 2^24, and the trunks equal when no sum
# passes it (scripts/qat_conv_exactness.py). The hybrid's head card vs CPU: the bf16 tail's rule BF16_HEAD_TOL;
# its FI embed: the reduced-precision embed bound of
# tests/test_torch_identification.py.
MODES_QAT_STEPS = 30
MODES_CALIB, MODES_HELD = 32, 32
MODES_DEPTHS = (2, 1)
MODES_TIMING_B = 32
MODES_FI_CROPS = 64
MODES_CPU_B, MODES_FI_CPU = 1, 4
MODES_FI_TOL = 3e-2
# [train-programs]: the captured training programs (phase 17) at 416², full
# width, seeded random weights, on phase 14's set and checkpoint. Eager vs
# replay over TP_STEPS steps, torch.equal on every param, BN and Adam tensor
# and loss: the detector cases (label, dtype, fake-quant, batch), the
# semi-hard triplet step at TP_TRIPLET_B, distillation QAT (lr 1e-5, the
# last 4 blocks, as phase 16). Two train_detector runs of TP_RUN_EPOCHS
# epochs at TP_RUN_B from one seed, with deterministic algorithms (equal
# checkpoints required) and without (the differing tensors printed). Step
# times eager vs replay, deterministic algorithms on and off, at TP_TIMING:
# two warm-up steps, then TP_TIMING_WINDOWS windows of TP_TIMING_STEPS steps
# between two CUDA events each (host launches included); triplets/s at
# TP_TRIPLET_TIMING_B (bf16, random mining); the busy share of f32 b16.
TP_STEPS = 8
TP_CASES = (("f32", torch.float32, False, 16), ("fakequant", torch.float32, True, 16),
            ("bf16", torch.bfloat16, False, 32))
TP_TRIPLET_B = 8
TP_RUN_EPOCHS, TP_RUN_B = 2, 16
TP_TIMING = (("f32", torch.float32, False, 16), ("f32", torch.float32, False, 32),
             ("fakequant", torch.float32, True, 16), ("bf16", torch.bfloat16, False, 128))
TP_TIMING_STEPS, TP_TIMING_WINDOWS = 3, 2
TP_TRIPLET_TIMING_B = 32
TP_LR = 1e-4
TP_RECAL_B = 24  # finalize_bn_stats: 160 images = 6 batches of 24 and one of 16
TP_QAT_LR, TP_QAT_TAIL = 1e-5, 4
# Published dense peaks of one H100 SXM at 700 W and its memory rate.
PEAK_INT8 = 1979e12  # int8 tensor-core operations / s
PEAK_BF16 = 989e12  # bf16 tensor-core operations / s
PEAK_F32 = 67e12  # f32 operations / s outside the tensor cores
HBM = 3.35e12  # bytes / s
# NMS: f32 operations per (live row i, later row j) IoU test: two overlaps
# (4 each), the product, the union (2), the division and the comparison;
# and per box its area (3), which the pairs share.
NMS_OPS_PER_PAIR = 13
NMS_OPS_PER_BOX = 3


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> list[float]:
    """Per-call times (ms) of `fn()`, each bracketed by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def graph_ms(fn, reps: int = 20) -> list[float]:
    """Device ms of one `fn()`: `reps` calls captured in one CUDA graph, the
    graph replayed between CUDA events (5 times), over the count. Host launch
    overhead, which per-call events include, stays out."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = [t / reps for t in cuda_ms(graph.replay, 5, warmup=1)]
    del graph
    return times


def traced_launches(prof) -> dict:
    """For each registered kernel wrapper (kernels.LAUNCH_COUNTERS), the
    launches of its kernels in a torch.profiler trace, by kernel name."""
    from face_vijnana_yolov3_tpu_torch import kernels

    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return {k.__name__: sum(any(t in n for t in k.trace_names) for n in names)
            for k in kernels.LAUNCH_COUNTERS}


def device_trace(fn, reps: int) -> dict:
    """`fn()` `reps` times under torch.profiler (CUDA activity), after one
    call, as ms a call: wall; device, the summed own time of the device
    events (kernels, copies, memsets); busy, the union of their intervals;
    copy, the copies' and memsets' share of device; and the busy share,
    busy / wall."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA))
    device = sum(b - a for a, b, _ in evs) / 1e3
    copy = sum(b - a for a, b, n in evs if n.startswith(("Memcpy", "Memset"))) / 1e3
    busy, end = 0.0, float("-inf")
    for a, b, _ in evs:
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e3
    return dict(wall_ms=wall / reps, device_ms=device / reps, busy_ms=busy / reps,
                copy_ms=copy / reps, busy=busy / wall, events=len(evs) / reps)


def trace_text(rates: dict, name: str, eager_fn, replay_fn) -> str:
    """`device_trace` of an eager and a replayed call; the numbers go to
    `rates` under `name`."""
    parts = []
    for m, fn in (("eager", eager_fn), ("replay", replay_fn)):
        t = device_trace(fn, PROGRAM_BUSY_REPS)
        rates[f"{name}_{m}_busy"] = t["busy"]
        rates[f"{name}_{m}_trace"] = t
        parts.append(f"{m} busy {t['busy']:.1%} (wall {t['wall_ms']:.3f}, busy "
                     f"{t['busy_ms']:.3f}, device {t['device_ms']:.3f}, copies "
                     f"{t['copy_ms']:.3f} ms, {t['events']:.0f} events a call)")
    return "; ".join(parts)


def quartiles(xs) -> str:
    q1, q2, q3 = np.percentile(xs, [25, 50, 75])
    return f"median {q2:.4f} ms (q1 {q1:.4f}, q3 {q3:.4f}, n={len(xs)})"


def bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """(least time in ms, what bounds it) for moving `nbytes` once and doing
    `ops` at `peak` operations per second."""
    t_bytes, t_ops = nbytes / HBM * 1e3, ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sorted_case(kind: str, b: int, n: int, rng):
    """Descending-sorted (boxes (B,N,4), scores (B,N)) on the card, 20 absent
    rows; "nonfinite": NaN and infinite coordinates on a few boxes;
    "absent": every score 0; "ties": scores on a 0.1 grid (equal
    scores in adjacent rows)."""
    if kind == "degenerate":
        boxes = np.zeros((b, n, 4), np.float32)  # 0/0 IoU everywhere
    else:
        mins = rng.uniform(0, 300, (b, n, 2))
        sizes = rng.uniform(10, 120, (b, n, 2))
        if kind == "integer":  # what the decode gives on the main path
            mins, sizes = np.floor(mins), np.floor(sizes)
        boxes = np.concatenate([mins, mins + sizes], -1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, (b, n)).astype(np.float32)
    for k in range(b):
        scores[k, rng.integers(0, n, 20)] = 0.0
    if kind == "nonfinite":  # NaN and infinite coordinates on a few boxes
        flat = boxes.reshape(-1)
        pick = rng.choice(flat.size, max(1, flat.size // 25), replace=False)
        flat[pick] = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32), pick.size)
    if kind == "absent":
        scores[:] = 0.0
    if kind == "ties":
        scores = np.round(scores, 1).astype(np.float32)
    scores = -np.sort(-scores, axis=-1)
    return torch.from_numpy(boxes).to(DEVICE), torch.from_numpy(scores).to(DEVICE)


def ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


def imread(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def write_images(path: str, rng) -> list[str]:
    """8 seeded noise JPEGs, landscape and portrait, of mixed sizes."""
    dims = [(480, 640), (640, 480), (360, 640), (720, 1280),
            (500, 375), (416, 416), (600, 800), (1024, 768)]
    files = []
    for i, (h, w) in enumerate(dims):
        fn = os.path.join(path, f"img_{i}.jpg")
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(fn)
        files.append(fn)
    return files


def check_csv(csv: str, n_files: int, what: str):
    rows = [line.split(",") for line in open(csv).read().splitlines()]
    per_image = collections.Counter(r[0] for r in rows)
    vals = np.asarray([[float(v) for v in r[1:]] for r in rows])
    if not rows or max(per_image.values()) > 60:
        raise AssertionError(f"{what}: solution_fd.csv rows per image: {per_image}")
    if not np.isfinite(vals).all() or (vals[:, 2:4] < 0).any():
        raise AssertionError(f"{what}: non-finite or negative-size rows")
    return (f"{len(rows)} rows over {len(per_image)} of {n_files} images (max "
            f"{max(per_image.values())} per image)")


# ------------------------------------------------------------------ int8 shapes


def trunk_int8_calls(ops, size: int, fused_blocks: bool):
    """The int8 kernel calls of one forward of the graph `ops` (the trunk,
    or the full YOLOv3 with its routes) at size², in order:
    ("conv", h, w, cin, cout, k, stride, skip) and ("block", h, w, c, ch),
    walked the way models/quant.apply_graph_quant walks the graph."""
    from face_vijnana_yolov3_tpu_torch.models import quant

    calls, hw, c, i, saved = [], size, 3, 0, {}
    while i < len(ops):
        op = ops[i]
        if fused_blocks and op[0] == "save" and quant._block_match(ops, i, c):
            calls.append(("block", hw, hw, c, ops[i + 1][2]))
            saved[op[1]] = (hw, c)
            i += 4
            continue
        if op[0] == "conv":
            _, _, cout, k, stride, _, _ = op
            skip = i + 1 < len(ops) and ops[i + 1][0] == "add"
            ho = (hw + 2 * (k // 2) - k) // stride + 1
            calls.append(("conv", hw, hw, c, cout, k, stride, skip))
            hw, c = ho, cout
            i += 2 if skip else 1
            continue
        if op[0] in ("save", "mark"):
            saved[op[1]] = (hw, c)
        elif op[0] == "restore":
            hw, c = saved[op[1]]
        elif op[0] == "concat":
            c += saved[op[1]][1]
        elif op[0] == "upsample":
            hw *= 2
        i += 1
    return calls


def int8_conv_operands(b, h, w, cin, cout, k, stride, skip, rng):
    """Random operands on the card with calibration-like scales: the
    requant lands mostly inside ±127, so rounding decides most outputs."""
    ho = (h + 2 * (k // 2) - k) // stride + 1
    wo = (w + 2 * (k // 2) - k) // stride + 1
    fan_in = k * k * cin
    t = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    args = dict(
        x_q=t(rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)),
        w_q=t(rng.integers(-127, 128, (cout, k, k, cin), dtype=np.int8)),
        w_scale=t((rng.uniform(0.5, 2, cout) / (127 * np.sqrt(fan_in))).astype(np.float32)),
        bias=t(rng.normal(0, 0.2, cout).astype(np.float32)),
        inv_out=t((127 / (60 * rng.uniform(1, 3, cout))).astype(np.float32)),
    )
    if skip:
        args["skip_q"] = t(rng.integers(-127, 128, (b, ho, wo, cout), dtype=np.int8))
        args["skip_s"] = t(rng.uniform(0.1, 0.5, cout).astype(np.float32))
    return args


def int8_block_operands(b, h, w, c, ch, rng):
    t = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    return (t(rng.integers(-127, 128, (b, h, w, c), dtype=np.int8)),
            t(rng.integers(-127, 128, (ch, 1, 1, c), dtype=np.int8)),
            t(rng.integers(-127, 128, (c, 3, 3, ch), dtype=np.int8)),
            t((rng.uniform(0.5, 2, ch) / (127 * np.sqrt(c))).astype(np.float32)),
            t(rng.normal(0, 0.2, ch).astype(np.float32)),
            t((127 / (60 * rng.uniform(1, 3, ch))).astype(np.float32)),
            t((rng.uniform(0.5, 2, c) / (127 * np.sqrt(9 * ch))).astype(np.float32)),
            t(rng.normal(0, 0.2, c).astype(np.float32)),
            t(rng.uniform(0.1, 0.5, c).astype(np.float32)),
            t((127 / (60 * rng.uniform(1, 3, c))).astype(np.float32)))


def conv_cost(b, h, w, cin, cout, k, stride, skip):
    """(bytes, int8 operations) of one conv_int8 call: each input read
    once, the output written once; 2 operations per multiply-add."""
    ho = (h + 2 * (k // 2) - k) // stride + 1
    wo = (w + 2 * (k // 2) - k) // stride + 1
    out = b * ho * wo * cout
    nbytes = b * h * w * cin + cout * k * k * cin + 12 * cout + out * (2 if skip else 1)
    nbytes += 4 * cout if skip else 0
    return nbytes, 2 * out * k * k * cin


def block_cost(b, h, w, c, ch):
    nbytes = 2 * b * h * w * c + 10 * c * ch + 12 * ch + 16 * c
    return nbytes, 2 * b * h * w * (c * ch + 9 * ch * c)


def int_mm_ms(gemms, rng, reps: int = 10) -> float:
    """Median device ms (graph_ms) of one torch._int_mm per (M, K, N)
    GEMM, summed: the library's int8 product with the operands already laid out (A row-major,
    B the weights (N, K) transposed); K is padded to a multiple of 8 where
    cuBLASLt needs it (conv_0's K = 27 → 32)."""
    total = 0.0
    for m, k, n in gemms:
        k = -(-k // 8) * 8
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(DEVICE)
        w = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)).to(DEVICE)
        total += float(np.median(graph_ms(lambda: torch._int_mm(a, w.t()), reps)))
        del a, w
    return total


# ------------------------------------------------------------------ phases


def check_int8_kernels(ops, rng) -> dict:
    """conv_int8 and block_int8 vs their plain versions on the card →
    {name: max |kernel - plain|} in int8 steps. Every trunk shape at b=8
    (conv) and b=32 (block), every one again at b=1, and ragged 11x19
    inputs at b=3 (new tile edges on both axes)."""
    from face_vijnana_yolov3_tpu_torch.ops.block_int8 import (
        block_int8,
        block_int8_reference,
    )
    from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import (
        conv_int8,
        conv_int8_reference,
    )

    err = {"conv_int8": 0, "block_int8": 0}
    on = trunk_int8_calls(ops, IMAGE_SIZE, True)
    off = trunk_int8_calls(ops, IMAGE_SIZE, False)
    trunk_convs = sorted({c[1:] for c in on + off if c[0] == "conv"},
                         key=lambda s: (-s[0], s[2], s[3]))
    ragged = sorted({(*RAGGED_HW, *c[2:]) for c in trunk_convs})
    conv_cases = ([(CONV_CHECK_B, s) for s in trunk_convs] + [(1, s) for s in trunk_convs]
                  + [(3, s) for s in ragged]
                  + [(CONV_CHECK_B, s) for s in ((37, 53, 64, 128, 3, 2, False),
                                                 (23, 41, 32, 64, 3, 1, True),
                                                 (19, 11, 256, 128, 1, 1, False))])
    for b, shape in conv_cases:
        a = int8_conv_operands(b, *shape, rng)
        kw = {k: a[k] for k in ("skip_q", "skip_s") if k in a}
        got = conv_int8(a["x_q"], a["w_q"], a["w_scale"], a["bias"], a["inv_out"],
                        stride=shape[5], leaky=True, **kw)
        want = conv_int8_reference(a["x_q"], a["w_q"], a["w_scale"], a["bias"],
                                   a["inv_out"], stride=shape[5], leaky=True, **kw)
        torch.cuda.synchronize()
        err["conv_int8"] = max(err["conv_int8"], int((got.int() - want.int()).abs().max()))
        live = float(((want != 0) & (want.abs() < 127)).float().mean())
        print(f"[kernels] conv_int8 b={b} (h, w, cin, cout, k, stride, skip)={shape}: "
              f"torch.equal {torch.equal(got, want)}; {live:.1%} of outputs inside "
              f"(0, 127)")
        if not torch.equal(got, want):
            raise AssertionError(f"conv_int8 != plain version at b={b} {shape}")
        del a, got, want
    block_shapes = sorted({c[1:] for c in on if c[0] == "block"}, reverse=True)
    block_cases = ([(TRUNK_B, s) for s in block_shapes] + [(1, s) for s in block_shapes]
                   + [(3, (*RAGGED_HW, *s[2:])) for s in block_shapes])
    for b, shape in block_cases:
        args = int8_block_operands(b, *shape, rng)
        got = block_int8(*args)
        want = block_int8_reference(*args)
        torch.cuda.synchronize()
        err["block_int8"] = max(err["block_int8"], int((got.int() - want.int()).abs().max()))
        live = float(((want != 0) & (want.abs() < 127)).float().mean())
        print(f"[kernels] block_int8 b={b} (h, w, c, ch)={shape}: torch.equal "
              f"{torch.equal(got, want)}; {live:.1%} of outputs inside (0, 127)")
        if not torch.equal(got, want):
            raise AssertionError(f"block_int8 != plain version at b={b} {shape}")
        del args, got, want
    return err


def time_int8_kernels(ops, card, rng) -> dict:
    """ms, plain ms, bound and _int_mm yardstick of each int8 kernel summed
    over the calls of one full-int8 trunk at TRUNK_B: with the fused blocks
    on (block_int8 and the 12 convs left to conv_int8), and conv_int8 again
    over the 52 convs of the trunk with the blocks off (the default path)."""
    from face_vijnana_yolov3_tpu_torch.ops.block_int8 import (
        block_int8,
        block_int8_reference,
    )
    from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import (
        conv_int8,
        conv_int8_reference,
    )

    trunks = {"on": collections.Counter(trunk_int8_calls(ops, IMAGE_SIZE, True)),
              "off": collections.Counter(trunk_int8_calls(ops, IMAGE_SIZE, False))}
    b = TRUNK_B
    per_call = {}
    for call in sorted(set(trunks["on"]) | set(trunks["off"]), key=lambda c: (c[0], -c[1])):
        shape = call[1:]
        if call[0] == "conv":
            h, w, cin, cout, k, stride, skip = shape
            a = int8_conv_operands(b, *shape, rng)
            kw = {key: a[key] for key in ("skip_q", "skip_s") if key in a}
            fn = lambda: conv_int8(a["x_q"], a["w_q"], a["w_scale"], a["bias"],  # noqa: E731
                                   a["inv_out"], stride=stride, leaky=True, **kw)
            plain = lambda: conv_int8_reference(  # noqa: E731
                a["x_q"], a["w_q"], a["w_scale"], a["bias"], a["inv_out"],
                stride=stride, leaky=True, **kw)
            nbytes, n_ops = conv_cost(b, *shape)
            ho = (h + 2 * (k // 2) - k) // stride + 1
            wo = (w + 2 * (k // 2) - k) // stride + 1
            gemms = [(b * ho * wo, k * k * cin, cout)]
            operands = a
        else:
            h, w, c, ch = shape
            args = int8_block_operands(b, *shape, rng)
            fn = lambda: block_int8(*args)  # noqa: E731
            plain = lambda: block_int8_reference(*args)  # noqa: E731
            nbytes, n_ops = block_cost(b, *shape)
            gemms = [(b * h * w, c, ch), (b * h * w, 9 * ch, c)]
            operands = args
        k_ms = float(np.median(graph_ms(fn)))
        call_ms = float(np.median(cuda_ms(fn, 20)))
        p_ms = float(np.median(cuda_ms(plain, 2, warmup=1)))
        lib_ms = int_mm_ms(gemms, rng)
        per_call[call] = dict(ms=k_ms, call_ms=call_ms, plain_ms=p_ms, library_ms=lib_ms,
                              bound_ms=bound(nbytes, n_ops, PEAK_INT8)[0],
                              t_bytes=nbytes / HBM * 1e3, t_ops=n_ops / PEAK_INT8 * 1e3)
        print(f"[kernels] {call[0]} b={b} {shape} x{trunks['on'][call]} per trunk with "
              f"the blocks on, x{trunks['off'][call]} off, on {card}: kernel {k_ms:.4f} "
              f"ms on the device, {n_ops / (k_ms * 1e-3) / 1e12:.1f} TOP/s ({call_ms:.4f} "
              f"ms a call between events, host launch included); plain {p_ms:.4f} ms; "
              f"_int_mm product {lib_ms:.4f} ms; bound {per_call[call]['bound_ms']:.4f} ms")
        del operands, fn, plain
    rec = {}
    for name, kind, trunk in (("conv_int8", "conv", "on"), ("block_int8", "block", "on"),
                              ("conv_int8 blocks off", "conv", "off")):
        r = {key: sum(n * per_call[c][key] for c, n in trunks[trunk].items() if c[0] == kind)
             for key in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "t_bytes",
                         "t_ops")}
        r["bound_by"] = "operations" if r.pop("t_ops") >= r.pop("t_bytes") else "bytes"
        r["calls"] = sum(n for c, n in trunks[trunk].items() if c[0] == kind)
        rec[name] = r
        print(f"[kernels] {name}: {r['calls']} calls of one int8 trunk at b={b} on {card}: "
              f"{r['ms']:.3f} ms on the device ({r['call_ms']:.3f} ms in calls between "
              f"events), plain {r['plain_ms']:.1f} ms, _int_mm products "
              f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
    return rec


def front_operands(b, size, rng):
    """Letterbox-like f32 input and folded conv_0/conv_1 params on the card,
    at He-like scales (the trunk's first two convs after folding)."""
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(DEVICE)  # noqa: E731
    x = t(rng.uniform(0, 1, (b, size, size, 3)))
    folded = {
        "conv_0": {"kernel": t(rng.normal(0, np.sqrt(2 / 27), (32, 3, 3, 3))),
                   "bias": t(rng.normal(0, 0.1, 32))},
        "conv_1": {"kernel": t(rng.normal(0, np.sqrt(2 / 288), (64, 32, 3, 3))),
                   "bias": t(rng.normal(0, 0.1, 64))},
    }
    return x, folded


def front_diff(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, float]:
    """(max |diff|, max |ref|, fraction of elements that differ)."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), float(want.float().abs().max()), float((d > 0).float().mean())


def check_front(rng) -> float:
    """fused_front vs fused_front_plain on the card → max |diff|."""
    from face_vijnana_yolov3_tpu_torch.ops.front_fused import (
        fused_front,
        fused_front_plain,
    )

    err = 0.0
    for b, size in FRONT_CHECKS:
        x, folded = front_operands(b, size, rng)
        got = fused_front(x, folded)
        want = fused_front_plain(x, folded)
        torch.cuda.synchronize()
        d_max, ref_max, frac = front_diff(got, want)
        err = max(err, d_max)
        print(f"[kernels] fused_front b={b} {size}²: max |diff| {d_max:.4g}, max |ref| "
              f"{ref_max:.4g} (tol {FRONT_STEP * ref_max:.4g}), {frac:.3g} of the "
              f"elements differ (tol {FRONT_MAX_FRACTION}); {tuple(got.shape)} "
              f"{got.dtype}")
        if not (got.shape == want.shape and got.dtype == torch.bfloat16
                and torch.isfinite(got.float()).all() and d_max <= FRONT_STEP * ref_max
                and frac <= FRONT_MAX_FRACTION):
            raise AssertionError(f"fused_front disagrees with its plain version at "
                                 f"b={b} {size}²")
    return err


def time_front(ops, card, rng) -> dict:
    """Device ms (a replayed CUDA graph) of fused_front at FRONT_B beside its
    plain twin, its bound, the two cuDNN bf16 convs and the port's stock
    depth-0 bf16 front, and the kernel's ms a call between CUDA events."""
    import torch.nn.functional as F

    from face_vijnana_yolov3_tpu_torch.models import darknet
    from face_vijnana_yolov3_tpu_torch.ops.front_fused import (
        fused_front,
        fused_front_plain,
    )

    b, s = FRONT_B, IMAGE_SIZE
    x, folded = front_operands(b, s, rng)
    k_ms = graph_ms(lambda: fused_front(x, folded))
    e_ms = cuda_ms(lambda: fused_front(x, folded), 20)
    p_ms = graph_ms(lambda: fused_front_plain(x, folded), reps=5)
    stock_ops = ops[:2] + [("output", "t")]
    stock_ms = graph_ms(lambda: darknet.apply_graph_folded(
        folded, x, stock_ops, compute_dtype=torch.bfloat16), reps=10)
    xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    k0 = folded["conv_0"]["kernel"].to(torch.bfloat16)
    k1 = folded["conv_1"]["kernel"].to(torch.bfloat16)
    y = F.conv2d(xb, k0, padding=1)

    def cudnn_pair():
        F.conv2d(xb, k0, padding=1)
        F.conv2d(y, k1, stride=2, padding=1)

    lib_ms = graph_ms(cudnn_pair)
    g = s // 2
    nbytes = b * s * s * 3 * 4 + b * g * g * 64 * 2 + 2 * (32 * 27 + 64 * 288) + 4 * 96
    n_ops = 2 * b * (s * s * 27 * 32 + g * g * 288 * 64)
    b_ms, b_by = bound(nbytes, n_ops, PEAK_BF16)
    rec = dict(ms=float(np.median(k_ms)), events_ms=float(np.median(e_ms)),
               plain_ms=float(np.median(p_ms)), library_ms=float(np.median(lib_ms)),
               stock_ms=float(np.median(stock_ms)), bound_ms=b_ms, bound_by=b_by)
    print(f"[kernels] fused_front b={b} {s}² on {card}, all on the device (CUDA graph "
          f"replay): kernel {quartiles(k_ms)}, {quartiles(e_ms)} a call between events, "
          f"{n_ops / (rec['ms'] * 1e-3) / 1e12:.1f} TFLOP/s, "
          f"{nbytes / (rec['ms'] * 1e-3) / 1e9:.0f} GB/s; plain {quartiles(p_ms)}; "
          f"two cuDNN bf16 convs (products only) {quartiles(lib_ms)}; the port's stock "
          f"depth-0 bf16 front {quartiles(stock_ms)}; bound {b_ms:.4f} ms by {b_by} "
          f"({nbytes / 1e6:.1f} MB, {n_ops / 1e9:.1f} GFLOP)")
    del x, folded, xb, y
    return rec


def bf16_slice(tmp, files, fdm, card, dev):
    """The bf16 serving path: the pipeline in test mode with the guard on
    "auto", the probe on 32 images, then the 416² b=32 detection program
    through apply_graph_folded_front. Returns (launch counts of this path,
    the pipeline for timing)."""
    from face_vijnana_yolov3_tpu_torch.api.config import load_conf
    from face_vijnana_yolov3_tpu_torch.models.detector import head_conv
    from face_vijnana_yolov3_tpu_torch.ops.front_fused import (
        apply_graph_folded_front,
        fused_front,
    )
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_host
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import nms_sweep
    from face_vijnana_yolov3_tpu_torch.ops.postprocess import face_postprocess_batch

    path = os.path.join(tmp, "conf_bf16.json")
    csv = os.path.join(tmp, "bf16.csv")
    with open(path, "w") as f:
        json.dump({"fd_conf": {
            "mode": "test", "test_path": tmp, "output_file_path": csv,
            "model_loading": True, "model_path": os.path.join(tmp, "fd_int8_tail0.pt"),
            "bf16_f32_front": "auto",
            "hps": {"face_conf_th": 0.05, "batch_size": 4},
            "nn_arch": {"image_size": IMAGE_SIZE},
        }}, f)
    conf = load_conf(path).fd_conf
    lb = np.asarray([letterbox_host(imread(f) / 255, IMAGE_SIZE, "cubic")[0]
                     for f in sorted(files)], np.float32)
    x32 = torch.from_numpy(np.concatenate([lb] * (FRONT_B // len(lb)))).to(dev)

    fused_front.launches = nms_sweep.launches = 0
    fd = fdm.FaceDetectorPipeline(conf, precision="bfloat16")
    fd.test()
    deferred = not hasattr(fd, "bf16_front_chosen")
    summary = check_csv(csv, len(files), "bf16")
    print(f"[bf16] test mode, bf16_f32_front auto, batches of 4: {summary}; the guard "
          f"probe deferred: {deferred} (fewer than 16 images), served depth "
          f"{fd._bf16_front_depth()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    depth, err = fd.autoselect_bf16_front(x32)
    torch.cuda.synchronize()
    print(f"[bf16] autoselect_bf16_front on {FRONT_B} images on {card}: depth {depth}, "
          f"1-boxF1 {err}, pinned {hasattr(fd, 'bf16_front_chosen')}, "
          f"{time.perf_counter() - t0:.2f} s")

    folded = fd._folded_params()
    with torch.inference_mode():
        trunk = apply_graph_folded_front(folded, x32, fd.model.ops)["trunk"]
        head = head_conv(trunk.to(torch.bfloat16), folded["head"], torch.bfloat16)
        cands, counts = face_postprocess_batch(head, fd._pp_cfg)
        ref = fd._bf16_head(x32, 0)
    torch.cuda.synchronize()
    launches = {"fused_front": fused_front.launches, "nms_sweep": nms_sweep.launches}
    h_err = float((head - ref).abs().max())
    h_max = float(ref.abs().max())
    print(f"[bf16] apply_graph_folded_front detection program, b={FRONT_B} "
          f"{IMAGE_SIZE}²: head {tuple(head.shape)} vs the pipeline's depth-0 head "
          f"max |diff| {h_err:.4g}, max |head| {h_max:.4g} (tol {BF16_HEAD_TOL} of max "
          f"|head|); counts {counts.tolist()[:8]}...; launches {launches}")
    if not (torch.isfinite(head).all() and h_err <= BF16_HEAD_TOL * h_max
            and cands.shape[::2] == (FRONT_B, 6) and torch.isfinite(cands).all()):
        raise AssertionError("the fused-front detection program disagrees with the "
                             "stock bf16 one")
    if min(launches.values()) == 0:
        raise AssertionError(f"the bf16 run skipped a kernel: {launches}")
    return launches, fd


def int8_slice(tmp, files, fdm, card, dev):
    """The int8 serving path through its entry point, then the bit-exact
    checks at full int8. Returns (launch counts of the main path, the
    full-int8 pipeline for timing, its calibration seconds)."""
    from face_vijnana_yolov3_tpu_torch.api.config import load_conf
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import save_checkpoint
    from face_vijnana_yolov3_tpu_torch.models import darknet, quant
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
    from face_vijnana_yolov3_tpu_torch.ops.block_int8 import block_int8
    from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import conv_int8
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_host
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import nms_sweep

    model = FaceDetectorModel(image_size=IMAGE_SIZE, device="cpu")
    params, state = model.init_params(SEED)
    darknet.perturb_batchnorm(params, state, model.ops, SEED + 1)
    sd = params_from_jax(params, state)
    confs = {}
    for pin in (3, 0):
        ckpt = os.path.join(tmp, f"fd_int8_tail{pin}.pt")
        save_checkpoint(ckpt, sd, meta={"int8_tail": pin})
        path = os.path.join(tmp, f"conf_int8_tail{pin}.json")
        with open(path, "w") as f:
            json.dump({"fd_conf": {
                "mode": "test", "test_path": tmp,
                "output_file_path": os.path.join(tmp, f"int8_tail{pin}.csv"),
                "model_loading": True, "model_path": ckpt,
                "int8_pallas_blocks": True,
                "hps": {"face_conf_th": 0.05, "batch_size": 4},
                "nn_arch": {"image_size": IMAGE_SIZE},
            }}, f)
        confs[pin] = load_conf(path).fd_conf

    # The main path: test() calibrates on its first batch, then serves.
    conv_int8.launches = block_int8.launches = nms_sweep.launches = 0
    fd = fdm.FaceDetectorPipeline(confs[3], precision="int8")
    fd.test()
    torch.cuda.synchronize()
    launches = {"conv_int8": conv_int8.launches, "block_int8": block_int8.launches,
                "nms_sweep": nms_sweep.launches}
    summary = check_csv(confs[3].output_file_path, len(files), "int8")
    print(f"[int8] test mode, int8_pallas_blocks on, trainmeta pin int8_tail 3: "
          f"{summary}; launches {launches}; tail chosen {fd.int8_tail_chosen} "
          f"(self-check 1-boxF1 {fd.int8_calib_err:.4f} on the first batch)")
    if min(launches.values()) == 0:
        raise AssertionError(f"the int8 run skipped a kernel: {launches}")
    if fd.int8_tail_chosen != 3 or fd._qparams.get("tail_start") != \
            quant.tail_start_index(fd.model.ops, 3):
        raise AssertionError("the trainmeta pin int8_tail 3 did not hold")

    # Full int8 (pin 0), calibrated on 32 letterboxed images.
    ops = fd.model.ops
    lb = np.asarray([letterbox_host(imread(f) / 255, IMAGE_SIZE, "cubic")[0]
                     for f in sorted(files)], np.float32)
    fd0 = fdm.FaceDetectorPipeline(confs[0], precision="int8")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fd0.calibrate_int8(np.concatenate([lb] * 4))
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    print(f"[int8] calibrate_int8 on 32 images (pin 0: one candidate) on {card}: "
          f"{calib_s:.2f} s; tail {fd0.int8_tail_chosen}, self-check 1-boxF1 "
          f"{fd0.int8_calib_err:.4f}")
    if fd0.int8_tail_chosen != 0 or "tail_start" in fd0._qparams:
        raise AssertionError("pin 0 did not give full int8")
    qp = fd0._qparams
    x2 = torch.from_numpy(lb[:2]).to(dev)
    with torch.inference_mode():
        on = quant.apply_graph_quant(qp, x2, ops, fused_blocks=True)["trunk"]
        off = quant.apply_graph_quant(qp, x2, ops, fused_blocks=False)["trunk"]
    cands_on, counts_on = fd0.detect_batch(lb[:2])
    fd0.conf.int8_pallas_blocks = False
    cands_off, counts_off = fd0.detect_batch(lb[:2])
    fd0.conf.int8_pallas_blocks = True
    torch.cuda.synchronize()
    s_out = torch.from_numpy(qp["act_scales"][-1].astype(np.float32))
    q_on = torch.round(on.cpu() / s_out)
    print(f"[int8] full int8 trunk {tuple(on.shape)}, fused blocks on vs off: "
          f"torch.equal {torch.equal(on, off)}; detect_batch cands equal "
          f"{np.array_equal(cands_on, cands_off)}, counts {counts_on.tolist()}; "
          f"{float(((q_on != 0) & (q_on.abs() < 127)).float().mean()):.1%} of the "
          f"int8 trunk output inside (0, 127)")
    if not (torch.equal(on, off) and np.array_equal(cands_on, cands_off)
            and np.array_equal(counts_on, counts_off)):
        raise AssertionError("the fused blocks change the int8 trunk")

    with torch.inference_mode():
        ref = fd0.model.apply_folded(fd0.model.fold(), x2, compute_dtype=torch.float32)
        head = fd0.model.apply_quant(qp, x2, fused_blocks=True)
    nrmse = float((head - ref).square().mean().sqrt() / ref.square().mean().sqrt())
    print(f"[int8] full int8 head vs the folded f32 head, 2 images: NRMSE {nrmse:.4f} "
          f"(tol {INT8_NRMSE_TOL}); the box-F1 self-check above reads 1.0 on these "
          f"weights because zero-area boxes make its IoU matrix NaN")
    if not nrmse <= INT8_NRMSE_TOL:
        raise AssertionError("the int8 head is far from the f32 one")

    qp_cpu = quant.to_device(qp, "cpu")
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu_trunk = quant.apply_graph_quant(qp_cpu, x2.cpu(), ops, fused_blocks=True)["trunk"]
        head_gpu = fd0.model.apply_quant(qp, x2, fused_blocks=True).cpu()
        head_cpu = fd0.model.apply_quant(qp_cpu, x2.cpu(), fused_blocks=True)
    cpu_s = time.perf_counter() - t0
    head_err = float((head_gpu - head_cpu).abs().max())
    head_max = float(head_cpu.abs().max())
    print(f"[int8] card vs CPU plain versions, full int8 at {IMAGE_SIZE}², 2 images: trunk "
          f"torch.equal {torch.equal(on.cpu(), cpu_trunk)} (CPU {cpu_s:.1f} s); bf16 "
          f"head max |diff| {head_err:.4g}, max |head| {head_max:.4g} (tol "
          f"{INT8_HEAD_TOL} of max |head|)")
    if not torch.equal(on.cpu(), cpu_trunk):
        raise AssertionError("the card's int8 trunk differs from the CPU's")
    if not (np.isfinite(head_gpu.numpy()).all() and head_err <= INT8_HEAD_TOL * head_max):
        raise AssertionError("the card's bf16 head disagrees with the CPU's")
    return launches, fd0, calib_s


# ------------------------------------------------------------------ new phases


def check_nms_large(card, rng) -> dict:
    """nms_sweep above the shared-memory bound (N > 1024, the mask in a
    device-memory workspace): torch.equal with the plain version at
    NMS_LARGE_B x NMS_LARGE_N x every case kind, then device and per-call
    times at B=NMS_TIMING_B2 for NMS_LARGE_TIMED beside the plain version
    and the bound. Returns {N: record} and the max |diff|."""
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import (
        nms_sweep,
        nms_sweep_reference,
    )

    kinds = ("float", "integer", "degenerate", "nonfinite", "absent", "ties")
    cases = [(kind, b, n) for kind in kinds for b in NMS_LARGE_B for n in NMS_LARGE_N]
    for kind, b, n in cases:
        boxes, scores = sorted_case(kind, b, n, rng)
        got = nms_sweep(boxes, scores, 0.5)
        want = nms_sweep_reference(boxes, scores, 0.5)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"nms_sweep != plain version ({kind}, B={b}, N={n})")
        del boxes, scores, got, want
        torch.cuda.empty_cache()
    print(f"[kernels] nms_sweep at N > 1024 (mask in a device-memory workspace): "
          f"torch.equal with the plain version in all {len(cases)} cases (B "
          f"{NMS_LARGE_B} x N {NMS_LARGE_N} x {'/'.join(kinds)})")
    recs = {}
    b = NMS_TIMING_B2
    for n in NMS_LARGE_TIMED:
        boxes, scores = sorted_case("integer", b, n, rng)
        d_ms = graph_ms(lambda: nms_sweep(boxes, scores, 0.5))
        k_ms = cuda_ms(lambda: nms_sweep(boxes, scores, 0.5), 20)
        p_ms = cuda_ms(lambda: nms_sweep_reference(boxes, scores, 0.5), 3, warmup=1)
        kept = nms_sweep(boxes, scores, 0.5) > 0
        pairs = int((kept * (n - 1 - torch.arange(n, device=boxes.device))).sum())
        b_ms, b_by = bound(b * n * (16 + 4 + 4), NMS_OPS_PER_PAIR * pairs
                           + NMS_OPS_PER_BOX * b * n, PEAK_F32)
        recs[n] = dict(ms=float(np.median(d_ms)), events_ms=float(np.median(k_ms)),
                       plain_ms=float(np.median(p_ms)), bound_ms=b_ms, bound_by=b_by)
        print(f"[kernels] nms_sweep B={b} N={n} (image_size {32 * int(n ** 0.5)}) on "
              f"{card}: kernel {quartiles(d_ms)} on the device, {quartiles(k_ms)} a call "
              f"between events; plain {quartiles(p_ms)}; bound {b_ms * 1e3:.3f} us by "
              f"{b_by} ({pairs} IoU tests); {int(kept.sum())} rows kept")
        del boxes, scores
    return recs


def serve_large(tmp, fdm, card, rng) -> int:
    """f32 test mode at image_size SERVE_LARGE (N = 1,089 > 1,024) on the
    card and on the CPU from one checkpoint: as many rows per image, each
    card row with a CPU row within one decoded pixel (the head's pixel in
    the original image's coordinates, max(h, w) / SERVE_LARGE: up to 1.82
    px at 1920 wide) and SERVE_SCORE_TOL, the boxes equal on SERVE_BOX_EXACT
    of them; a card row with no such CPU row is printed beside its nearest
    CPU row. Returns the nms_sweep launches."""
    from face_vijnana_yolov3_tpu_torch.api.config import FdConf
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import save_checkpoint
    from face_vijnana_yolov3_tpu_torch.models import darknet
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import nms_sweep

    d = os.path.join(tmp, "serve_large")
    os.makedirs(d)
    pixel = {}  # one decoded pixel, in original pixels
    for i, (h, w) in enumerate([(1200, 1600), (1080, 1920), (1400, 1050), (1056, 1056)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(d, f"big_{i}.jpg"))
        pixel[f"big_{i}.jpg"] = max(h, w) / SERVE_LARGE
    # Seeded BN statistics spread the scores, so the 60 rows an image keeps
    # are not decided by ties that an ULP of the head reorders.
    ckpt = os.path.join(tmp, "fd_large.pt")
    model = FaceDetectorModel(image_size=SERVE_LARGE, device="cpu")
    params, state = model.init_params(SEED)
    darknet.perturb_batchnorm(params, state, model.ops, SEED + 1)
    save_checkpoint(ckpt, params_from_jax(params, state))
    out = {}
    for device in ("cuda", "cpu"):
        conf = FdConf(mode="test", test_path=d, model_loading=True, model_path=ckpt,
                      output_file_path=os.path.join(tmp, f"large_{device}.csv"))
        conf.nn_arch.image_size = SERVE_LARGE
        conf.hps.face_conf_th, conf.hps.batch_size = 0.05, 2
        if device == "cuda":  # the path whose kernel launches count
            nms_sweep.launches = 0
        t0 = time.perf_counter()
        fdm.FaceDetectorPipeline(conf, device=device).test()
        torch.cuda.synchronize()
        out[device] = (open(conf.output_file_path).read().splitlines(),
                       time.perf_counter() - t0)
        if device == "cuda":
            launches = nms_sweep.launches
    per_image = {}
    for device, (lines, _) in out.items():
        for line in lines:
            f = line.split(",")
            per_image.setdefault(f[0], {}).setdefault(device, []).append(
                [float(v) for v in f[1:]])
    n_rows = len(out["cpu"][0])
    exact = matched = 0
    worst_px = worst_score = 0.0
    unmatched = []
    for name, rows in per_image.items():
        card_rows, cpu_rows = rows.get("cuda", []), list(rows.get("cpu", []))
        if len(card_rows) != len(cpu_rows):
            raise AssertionError(f"[serve] {SERVE_LARGE}² {name}: {len(card_rows)} rows "
                                 f"on the card, {len(cpu_rows)} on the CPU")
        for r in card_rows:  # the CPU row closest to each card row
            d = [np.abs(np.asarray(r) - np.asarray(c)) for c in cpu_rows]
            k = int(np.argmin([max(x[:4].max(), x[4] / SERVE_SCORE_TOL) for x in d]))
            if d[k][:4].max() <= pixel[name] + 1e-9 and d[k][4] <= SERVE_SCORE_TOL:
                matched += 1
                exact += int((d[k][:4] == 0).all())
                worst_px = max(worst_px, float(d[k][:4].max()))
                worst_score = max(worst_score, float(d[k][4]))
                cpu_rows.pop(k)
            else:
                unmatched.append((name, r, cpu_rows[k], d[k].tolist()))
    print(f"[serve] f32 test mode at {SERVE_LARGE}² (N = {(SERVE_LARGE // 32) ** 2}), 4 "
          f"JPEGs, batch 2, on {card}: {n_rows} rows on both; {matched} card rows have a "
          f"CPU row within one decoded pixel and {SERVE_SCORE_TOL} (tol: all), {exact} "
          f"of them with "
          f"the box equal (tol: >= {SERVE_BOX_EXACT:.0%}); worst {worst_px:g} px, "
          f"{worst_score:.3g} in score; nms_sweep launches {launches}; card "
          f"{out['cuda'][1]:.1f} s, CPU {out['cpu'][1]:.1f} s")
    for name, r, c, delta in unmatched:  # x, y, w, h, score
        print(f"[serve] unmatched {name}: card {r}, nearest CPU {c}, |delta| {delta}")
    if not (n_rows and matched == n_rows and exact >= SERVE_BOX_EXACT * n_rows
            and launches > 0):
        raise AssertionError(f"[serve] the card's {SERVE_LARGE}² CSV disagrees with the CPU's")
    return launches


def calib_quotients(dev) -> dict:
    """The quantization path's divisions by 127 (phase 9) on the same
    host-made inputs on the card and on the CPU: the "auto" and msegrid
    candidate grids (`quant.auto_grid`, `msegrid_grid`: the jitted JAX
    walk's product with f32(1/127)) and the training fake-quant's scales
    (`darknet._act_fq` on seeded activations at the trunk's shapes,
    `darknet._weight_fq` on seeded kernels of every trunk conv: the f32
    quotient, `darknet.div_127`), each torch.equal card vs CPU. Counts the
    elements the parent's form (`t / 127.0`) puts elsewhere on each device:
    the card's is the reciprocal product, the CPU's the quotient."""
    from face_vijnana_yolov3_tpu_torch.models import darknet, quant

    gen = np.random.default_rng(SEED + 30)

    def maxabs_like(*shape):
        return torch.from_numpy((np.abs(gen.standard_normal(shape))
                                 * 10.0 ** gen.uniform(-3, 2, shape)).astype(np.float32))

    def parent_moved(t, new, d):
        """Elements of `new` that the parent's `t / 127.0` on device d misses."""
        return int((t.to(d) / 127.0).cpu().ne(new).sum())

    cands, m = maxabs_like(3, 1024), maxabs_like(4096)
    ratios = torch.from_numpy(quant.msegrid_ratios().astype(np.float32))
    sites = {}
    grids = (("auto grid", lambda d: quant.auto_grid(cands.to(d)),
              torch.clamp_min(cands, 1e-8)),
             ("msegrid grid", lambda d: quant.msegrid_grid(m.to(d), ratios.to(d)),
              torch.clamp_min(m, 1e-8)[None, :] * ratios[:, None]))
    for name, fn, numer in grids:
        got, want = fn(dev).cpu(), fn("cpu")
        sites[name] = (torch.equal(got, want), want.numel(), parent_moved(numer, want, dev),
                       parent_moved(numer, want, "cpu"))
    shapes = [(2, c, IMAGE_SIZE // r, IMAGE_SIZE // r)
              for c, r in ((32, 1), (64, 2), (128, 4), (256, 8), (512, 16), (1024, 32))]
    act = [0, 0, 0, 0, True]
    for shape in shapes:
        h = (torch.from_numpy(gen.standard_normal(shape).astype(np.float32))
             * maxabs_like(shape[1])[None, :, None, None])
        v_dev, s_dev = darknet._act_fq(h.to(dev))
        v_cpu, s_cpu = darknet._act_fq(h)
        act[4] &= torch.equal(s_dev.cpu(), s_cpu) and torch.equal(v_dev.cpu(), v_cpu)
        numer = torch.clamp_min(h.abs().amax(dim=(0, 2, 3)), 1e-6)
        act[1] += s_cpu.numel()
        act[2] += parent_moved(numer, s_cpu, dev)
        act[3] += parent_moved(numer, s_cpu, "cpu")
    sites["_act_fq scale"] = (act[4], act[1], act[2], act[3])
    wfq = [True, 0, 0, 0]
    for _idx, cin, cout, k, _stride, _bn in darknet.conv_layout(darknet.trunk_graph()):
        kern = torch.from_numpy(gen.normal(0, 0.1, (cout, cin, k, k)).astype(np.float32))
        s_in = darknet.div_127(maxabs_like(cin))
        got = darknet._weight_fq(kern.to(dev), s_in.to(dev)).cpu()
        want = darknet._weight_fq(kern, s_in)
        wfq[0] &= torch.equal(got, want)
        numer = torch.clamp_min((kern * s_in[None, :, None, None]).abs().amax(dim=(1, 2, 3)),
                                1e-8)
        w_scale = darknet.div_127(numer)
        wfq[1] += w_scale.numel()
        wfq[2] += parent_moved(numer, w_scale, dev)
        wfq[3] += parent_moved(numer, w_scale, "cpu")
    sites["_weight_fq w_scale"] = tuple(wfq)
    for name, (equal, n, moved_dev, moved_cpu) in sites.items():
        print(f"[calib] {name}, card vs CPU on the same host-made inputs: torch.equal "
              f"{equal} over {n} scales; the parent's `/ 127.0` would put {moved_dev} of "
              f"them elsewhere on the card, {moved_cpu} on the CPU")
    if not all(v[0] for v in sites.values()):
        raise AssertionError("[calib] a division by 127 differs between card and CPU")
    return {name: {"elements": v[1], "parent_moved_card": v[2], "parent_moved_cpu": v[3]}
            for name, v in sites.items()}


def calib_phase(card, dev, rng):
    """int8 calibration on the card vs the CPU port: the divisions by 127
    (`calib_quotients`, whose counts it returns), msegrid scales (rtol
    CALIB_SCALE_RTOL: each position's max comes from f32 forwards whose
    convs sum in another order), then bias correction on the CPU's msegrid
    scales: kernel_q and w_scale bit-identical, biases within
    CALIB_BIAS_FRACTION of each conv's largest correction."""
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
    from face_vijnana_yolov3_tpu_torch.models import darknet, quant
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel

    quotients = calib_quotients(dev)
    model = FaceDetectorModel(image_size=IMAGE_SIZE, device="cpu")
    params, state = model.init_params(SEED + 2)
    darknet.perturb_batchnorm(params, state, model.ops, SEED + 3)
    model.load_state_dict(params_from_jax(params, state))
    folded_cpu = model.fold()
    folded_dev = {k: {n: t.to(dev) for n, t in v.items()} for k, v in folded_cpu.items()}
    x = rng.uniform(0, 1, (CALIB_IMAGES, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    ops = model.ops
    t0 = time.perf_counter()
    s_dev = quant.calibrate_folded(folded_dev, torch.from_numpy(x).to(dev), ops,
                                   percentile="msegrid")
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_cpu = quant.calibrate_folded(folded_cpu, torch.from_numpy(x), ops, percentile="msegrid")
    cpu_s = time.perf_counter() - t0
    rel = max(float(np.abs(a / b - 1).max()) for a, b in zip(s_dev, s_cpu))
    same = sum(int((a == b).sum()) for a, b in zip(s_dev, s_cpu))
    total = sum(b.size for b in s_cpu)
    print(f"[calib] msegrid scales, {CALIB_IMAGES} images at {IMAGE_SIZE}², card vs CPU: "
          f"{same} of {total} channels bit-identical, max rel diff {rel:.3g} (tol "
          f"{CALIB_SCALE_RTOL}); card {dev_s:.2f} s on {card}, CPU {cpu_s:.1f} s")
    if rel > CALIB_SCALE_RTOL:
        raise AssertionError("[calib] msegrid scales differ between card and CPU")
    t0 = time.perf_counter()
    q_dev = quant.quantize_folded(folded_dev, torch.from_numpy(x).to(dev), ops,
                                  act_scales=s_cpu, bias_correct=True)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    q_cpu = quant.quantize_folded(folded_cpu, torch.from_numpy(x), ops, act_scales=s_cpu,
                                  bias_correct=True)
    q_plain = quant.quantize_folded(folded_cpu, None, ops, act_scales=s_cpu)
    worst_abs, worst_rel = 0.0, 0.0
    for op in ops:
        if op[0] != "conv":
            continue
        k = f"conv_{op[1]}"
        if not (torch.equal(q_dev[k]["kernel_q"], q_cpu[k]["kernel_q"])
                and torch.equal(q_dev[k]["w_scale"], q_cpu[k]["w_scale"])):
            raise AssertionError(f"[calib] {k}: kernel_q or w_scale differ card vs CPU")
        diff = float((q_dev[k]["bias"] - q_cpu[k]["bias"]).abs().max())
        corr = float((q_cpu[k]["bias"] - q_plain[k]["bias"]).abs().max())
        worst_abs = max(worst_abs, diff)
        worst_rel = max(worst_rel, diff / max(corr, 1e-30))
    print(f"[calib] bias correction on the same scales, card vs CPU: kernel_q and "
          f"w_scale bit-identical; biases max |diff| {worst_abs:.3g}, at most "
          f"{worst_rel:.3g} of the conv's largest correction (tol "
          f"{CALIB_BIAS_FRACTION}); card {dev_s:.2f} s")
    if worst_rel > CALIB_BIAS_FRACTION:
        raise AssertionError("[calib] bias-corrected biases differ between card and CPU")
    return quotients


def profile_split(fn, steps: int) -> dict:
    """Device ms a call of `fn` by kernel family (torch.profiler over
    `steps` calls): convolutions (cuDNN and GEMM kernels), reductions (BN
    statistics and their gradients), the optimizer's foreach kernels, the
    other elementwise passes, and the rest. CUDA activity only (not the
    port's utils.profiling.device_trace, which also records and exports
    host events): the smoke's host-bound timings run right after it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    split = collections.Counter()
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if not t or ev.key.startswith(("ProfilerStep", "cuda", "aten::")):
            continue
        name = ev.key.lower()
        if any(s in name for s in ("conv", "cudnn", "xmma", "gemm", "wgrad", "dgrad",
                                   "winograd", "fft", "implicit", "sm90_", "sm80_")):
            split["convs"] += t
        elif "multi_tensor" in name or "foreach" in name:
            split["optimizer"] += t
        elif "reduce" in name:
            split["reductions (BN)"] += t
        elif "elementwise" in name or "vectorized" in name or "unrolled" in name:
            split["elementwise"] += t
        else:
            split["other"] += t
    return {k: v / 1e3 / steps for k, v in split.items()}


def train_phase(tmp, fdm, card, dev):
    """Detector training on the card: one f32 step at b2 vs the CPU port,
    then train_detector on the seeded synthetic set at 416² (f32 through
    the CLI's mode=train, bf16 mixed at two batches, fake-quant QAT),
    train_img_s and peak memory, the trained checkpoint served at f32 and
    int8 (A0, A and B must launch), evaluate + the mAP harness. Returns
    {label: (img/s, batch, peak GB)} and the serving launch counts."""
    from face_vijnana_yolov3_tpu_torch.api.config import FdConf
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import load_train_meta
    from face_vijnana_yolov3_tpu_torch.data import synthetic
    from face_vijnana_yolov3_tpu_torch.data.uccs import DetectionDataset
    from face_vijnana_yolov3_tpu_torch.evals.detection import map_sweep
    from face_vijnana_yolov3_tpu_torch.models import darknet
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
    from face_vijnana_yolov3_tpu_torch.ops.block_int8 import block_int8
    from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import conv_int8
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import nms_sweep
    from face_vijnana_yolov3_tpu_torch.train import optimizer, trainer

    root = synthetic.make_dataset(os.path.join(tmp, "synthetic"), n_train=TRAIN_IMAGES,
                                  n_val=VAL_IMAGES, image_size=TRAIN_SOURCE_SIZE, seed=SEED)
    ds = DetectionDataset(root, image_size=IMAGE_SIZE, grid=IMAGE_SIZE // 32,
                          cache="samples")

    # One f32 step at b2: the card vs the CPU port, same weights and batch.
    model_cpu = FaceDetectorModel(image_size=IMAGE_SIZE, device="cpu")
    sd = params_from_jax(*model_cpu.init_params(SEED + 4))
    model_dev = FaceDetectorModel(image_size=IMAGE_SIZE, device=dev)
    images, gts = ds.batch(0, 2)
    w = np.ones(2, np.float32)
    res = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, model, device in (("card", model_dev, dev), ("cpu", model_cpu, "cpu")):
        p, s = darknet.split_state_dict({k: v.to(device) for k, v in sd.items()})
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        pred, new_state = model.apply_train(leaves, s, torch.from_numpy(images).to(device))
        per = torch.mean(torch.square(pred - torch.from_numpy(gts).to(device)), dim=(1, 2, 3))
        loss = torch.sum(per * torch.from_numpy(w).to(device)) / float(w.sum())
        loss.backward()
        opt = optimizer.KerasAdam(TRAIN_LR)
        upd, _ = opt.update({k: v.grad for k, v in leaves.items()}, opt.init(p))
        res[name] = dict(loss=float(loss.detach()),
                         grads={k: v.grad.detach().cpu() for k, v in leaves.items()},
                         state={k: v.cpu() for k, v in new_state.items()},
                         params={k: (p[k] + upd[k]).cpu() for k in p})
    c, h = res["card"], res["cpu"]
    loss_rel = abs(c["loss"] - h["loss"]) / abs(h["loss"])
    g_tot = sum(float(g.norm()) ** 2 for g in h["grads"].values()) ** 0.5
    g_diff = sum(float((c["grads"][k] - g).norm()) ** 2 for k, g in h["grads"].items()) ** 0.5
    g_worst = max(float((c["grads"][k] - g).norm() / g.norm()) for k, g in h["grads"].items())
    s_err = max(float((c["state"][k] - v).abs().max() / v.abs().max())
                for k, v in h["state"].items())
    p_diff = torch.cat([(c["params"][k] - v).abs().flatten() for k, v in h["params"].items()])
    p_max, p_moved = float(p_diff.max()), float((p_diff > 1e-3 * TRAIN_LR).float().mean())
    print(f"[train] one f32 step at b2 {IMAGE_SIZE}², card vs CPU port on {card}: loss "
          f"{c['loss']:.6f} vs {h['loss']:.6f} (rel {loss_rel:.2g}, tol {STEP_LOSS_RTOL}); "
          f"grads {g_diff / g_tot:.2g} of their norm (tol {STEP_GRAD_TOL}), worst param "
          f"{g_worst:.2g} (tol {STEP_PARAM_GRAD_TOL}); BN statistics {s_err:.2g} (tol "
          f"{STEP_STATE_TOL}); updated params max |diff| {p_max:.3g} (tol {2 * TRAIN_LR}), "
          f"{p_moved:.3%} of them beyond {1e-3 * TRAIN_LR:g} (tol 1%)")
    if not (loss_rel <= STEP_LOSS_RTOL and g_diff <= STEP_GRAD_TOL * g_tot
            and g_worst <= STEP_PARAM_GRAD_TOL and s_err <= STEP_STATE_TOL
            and p_max <= 2 * TRAIN_LR and p_moved <= 0.01):
        raise AssertionError("[train] the card's f32 step disagrees with the CPU port's")
    del res, model_cpu, c, h
    torch.cuda.empty_cache()

    # train_detector: f32 through the CLI (mode=train), then bf16 and QAT.
    ckpts = {}
    for label, precision, qat, b in TRAIN_RUNS:
        ckpt = os.path.join(tmp, f"trained_{label}.pt")
        overrides = {"mode": "train", "raw_data_path": root, "model_path": ckpt,
                     "weights_path": "none.weights", "train_qat": qat,
                     "hps": {"batch_size": b, "epochs": TRAIN_EPOCHS, "lr": TRAIN_LR},
                     "nn_arch": {"image_size": IMAGE_SIZE}}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            if precision == "float32" and not qat:
                path = os.path.join(tmp, f"conf_{label}.json")
                with open(path, "w") as f:
                    json.dump({"fd_conf": overrides}, f)
                fdm.main([f"--conf={path}"])
            else:
                conf = FdConf(**{k: v for k, v in overrides.items()
                                 if k not in ("hps", "nn_arch")})
                conf.nn_arch.image_size = IMAGE_SIZE
                for k, v in overrides["hps"].items():
                    setattr(conf.hps, k, v)
                fdm.FaceDetectorPipeline(conf, precision=precision).train()
        except torch.cuda.OutOfMemoryError:
            print(f"[train] {label}: b={b} does not fit in {card} "
                  f"({torch.cuda.max_memory_allocated() / 2**30:.1f} GiB allocated at "
                  f"the failure)")
            torch.cuda.empty_cache()
            continue
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hist = [json.loads(line)["loss"] for line in open(ckpt + "_history.jsonl")]
        steps = len(hist) // TRAIN_EPOCHS
        first, last = np.mean(hist[:steps]), np.mean(hist[-steps:])
        print(f"[train] {label} ({precision}{', fake-quant' if qat else ''}) b={b}, "
              f"{TRAIN_EPOCHS} epochs of {steps} steps on {TRAIN_IMAGES} synthetic "
              f"images, {card}: epoch mean loss {first:.5f} -> {last:.5f}; {wall:.1f} s "
              f"with finalize_bn_stats and the save; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        if not (np.isfinite(hist).all() and last < first):
            raise AssertionError(f"[train] {label}: loss did not fall ({first} -> {last})")
        ckpts[label] = ckpt

    # train_img_s: the train step on device-resident batches, events over
    # TRAIN_TIMING_STEPS steps after two warm-up steps.
    rates = {}
    model = FaceDetectorModel(image_size=IMAGE_SIZE, device=dev)
    for label, dtype, b in TRAIN_TIMING_RUNS:
        if label in rates:
            continue
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        p, s = darknet.split_state_dict({k: v.to(dev) for k, v in sd.items()})
        opt = optimizer.KerasAdam(TRAIN_LR)
        step = trainer.make_train_step(model, opt, compute_dtype=dtype)
        images, gts = ds.batch(0, len(ds))
        reps = -(-b // len(ds))
        xs = torch.from_numpy(np.concatenate([images] * reps)[:b]).to(dev).to(dtype)
        ys = torch.from_numpy(np.concatenate([gts] * reps)[:b]).to(dev)
        ws = torch.ones(b, device=dev)
        carry = [p, s, opt.init(p)]

        def run():
            carry[0], carry[1], carry[2], _ = step(*carry, xs, ys, ws)

        try:
            ms = cuda_ms(run, TRAIN_TIMING_STEPS, warmup=2)
        except torch.cuda.OutOfMemoryError:
            print(f"[train] train step {label} b={b} does not fit in {card}; timing a "
                  f"smaller batch")
            del carry, xs, ys
            continue
        peak = torch.cuda.max_memory_allocated() / 2**30
        split = profile_split(run, 2)
        rates[label] = (b / (np.median(ms) / 1e3), b, peak)
        split_txt = ", ".join(f"{k} {v:.1f}" for k, v in sorted(split.items(),
                                                              key=lambda kv: -kv[1]))
        print(f"[train] train_img_s {label} b={b} at {IMAGE_SIZE}² on {card}: "
              f"{rates[label][0]:.1f} img/s; step {quartiles(ms)}; peak "
              f"{peak:.1f} GiB (max_memory_allocated); device ms a step by kernel "
              f"family: {split_txt} (sum {sum(split.values()):.1f})")
        del carry, xs, ys, step
    torch.cuda.empty_cache()

    # The trained f32 checkpoint (finalize_bn_stats ran, trainmeta saved)
    # served at f32 and int8, then evaluate + the mAP harness.
    ckpt = ckpts["f32"]
    files = [f for f in os.listdir(root) if f.endswith(".jpg")]
    launches = {}
    for precision in ("float32", "int8"):
        conf = FdConf(mode="test", test_path=root, model_loading=True, model_path=ckpt,
                      output_file_path=os.path.join(tmp, f"trained_{precision}.csv"),
                      int8_pallas_blocks=True)
        conf.nn_arch.image_size = IMAGE_SIZE
        conf.hps.batch_size, conf.hps.face_conf_th = 32, 0.05
        conv_int8.launches = block_int8.launches = nms_sweep.launches = 0
        fd = fdm.FaceDetectorPipeline(conf, precision=precision)
        fd.test()
        torch.cuda.synchronize()
        launches[precision] = {"conv_int8": conv_int8.launches,
                               "block_int8": block_int8.launches,
                               "nms_sweep": nms_sweep.launches}
        summary = check_csv(conf.output_file_path, len(files), precision)
        print(f"[train] the trained checkpoint served at {precision} (test mode, "
              f"{len(files)} images): {summary}; launches {launches[precision]}")
        need = (("conv_int8", "block_int8", "nms_sweep") if precision == "int8"
                else ("nms_sweep",))
        if min(launches[precision][k] for k in need) == 0:
            raise AssertionError(f"[train] serving the trained checkpoint at {precision} "
                                 f"skipped a kernel: {launches[precision]}")
    print(f"[train] trainmeta of the trained checkpoint: {load_train_meta(ckpt)}; "
          f"QAT one: {load_train_meta(ckpts['qat'])}")
    conf = FdConf(mode="evaluate", test_path=root, model_loading=True, model_path=ckpt,
                  output_file_path=os.path.join(tmp, "trained_eval.csv"))
    conf.nn_arch.image_size = IMAGE_SIZE
    conf.hps.batch_size, conf.hps.face_conf_th = 32, 0.05
    cwd = os.getcwd()
    os.chdir(tmp)  # evaluate writes ratios.csv to the working directory
    try:
        fdm.FaceDetectorPipeline(conf).evaluate()
    finally:
        os.chdir(cwd)
    val = os.path.join(tmp, "trained_val.csv")
    with open(val, "w") as f:
        f.writelines(r + "\n" for r in open(conf.output_file_path).read().splitlines()
                     if r.startswith("val_"))
    _, _, aps = map_sweep(os.path.join(root, "validation.csv"), val, out_h5=None)
    print(f"[train] evaluate + the mAP harness on the {VAL_IMAGES} held-out images "
          f"(not gated: {TRAIN_EPOCHS} epochs on {TRAIN_IMAGES} synthetic images): AP50 "
          f"{aps[0]:.4f}, AP50:95 {np.mean(aps):.4f}")

    # Which JPEG decoder the device-letterbox path ran.
    os.environ["FVY_DEVICE_LETTERBOX"] = "1"
    try:
        conf = FdConf(mode="test", test_path=root, model_loading=True, model_path=ckpt,
                      output_file_path=os.path.join(tmp, "trained_native.csv"))
        conf.nn_arch.image_size = IMAGE_SIZE
        conf.hps.batch_size, conf.hps.face_conf_th = 32, 0.05
        fd = fdm.FaceDetectorPipeline(conf)
        fd.test()
    finally:
        del os.environ["FVY_DEVICE_LETTERBOX"]
    print(f"[train] JPEG decoder of the device-letterbox path: {fd.jpeg_decoder} "
          f"({check_csv(conf.output_file_path, len(files), 'native')})")
    return rates, launches


def _tie_ok(pick, e_ref, reg) -> bool:
    """Each `pick` (registry rows chosen from other embeddings) is the
    minimum for the reference embeddings `e_ref`, or within FI_DIST_TOL of
    it (a tie)."""
    d = torch.cdist(e_ref.double(), reg.double())
    chosen = d.gather(1, pick.long()[:, None])[:, 0]
    return bool((chosen - d.min(1).values <= FI_DIST_TOL).all())


def identify_phase(tmp, card, dev):
    """Face identification on the card (phase 11): the subject DB (data,
    fid_db and the registry) of a seeded synthetic identity tree through
    the CLI, test mode at f32 on the host-crop and device-ROI paths,
    hand-made boxes through the f32, int8 and bf16 pipelines (the main
    path, with the launch counts zeroed before it and read after it); then
    card vs CPU port (identify rows, device crops vs host crops, the int8
    embed trunk bit for bit on the same qparams), embed and identify
    timings, a short triplet training (one f32 step card vs CPU, bf16 mixed
    at b32, f32 at b8, semi_hard), triplets/s and peak memory, and the
    held-out top-1 after training (printed, not gated). Returns (launches,
    {metric: value})."""
    import random

    import pandas as pd

    from face_vijnana_yolov3_tpu_torch.api import face_identification as fim
    from face_vijnana_yolov3_tpu_torch.api.config import load_conf
    from face_vijnana_yolov3_tpu_torch.convert import (
        identifier_params_from_jax,
        params_from_jax,
    )
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import load_checkpoint, save_checkpoint
    from face_vijnana_yolov3_tpu_torch.data import facedb, synthetic
    from face_vijnana_yolov3_tpu_torch.models import darknet, quant
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
    from face_vijnana_yolov3_tpu_torch.models.identifier import (
        FaceIdentifierModel,
        triplet_step_loss,
    )
    from face_vijnana_yolov3_tpu_torch.ops.block_int8 import block_int8
    from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import conv_int8
    from face_vijnana_yolov3_tpu_torch.ops.front_fused import fused_front
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_host
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import nms_sweep
    from face_vijnana_yolov3_tpu_torch.ops.similarity import match_embeddings
    from face_vijnana_yolov3_tpu_torch.train import optimizer, trainer

    fim.DEBUG = False
    S = IMAGE_SIZE
    root = os.path.join(tmp, "fi")
    holdout = synthetic.make_fi_tree(
        root, FI_SUBJECTS, seed=SEED, hold_per_subj=FI_HOLD_PER_SUBJ,
        train_per_subj=FI_TRAIN_PER_SUBJ, image_size=S,
        face_sizes=(S * 90 // 416, S * 200 // 416))
    train_dir = os.path.join(root, "training")
    gt = pd.read_csv(os.path.join(train_dir, "training.csv"))

    # Seeded random weights with perturbed BN statistics: the identifier's
    # int8 trunk then carries live values, and the detector finds some boxes
    # of non-zero size (as in [int8]).
    fi_model = FaceIdentifierModel(image_size=S, device="cpu")
    params, state = fi_model.init_params(SEED + 7)
    darknet.perturb_batchnorm(params, state, fi_model.ops, SEED + 8)
    ops = fi_model.ops
    del fi_model
    fi_ckpt = os.path.join(tmp, "fi_random.pt")
    save_checkpoint(fi_ckpt, identifier_params_from_jax(params, state),
                    meta={"seed": SEED + 7})
    del params, state
    fd_model = FaceDetectorModel(image_size=S, device="cpu")
    params, state = fd_model.init_params(SEED)
    darknet.perturb_batchnorm(params, state, fd_model.ops, SEED + 1)
    fd_ckpt = os.path.join(tmp, "fd_random_fi.pt")
    save_checkpoint(fd_ckpt, params_from_jax(params, state))
    del fd_model, params, state
    conf_path = os.path.join(tmp, "conf_fi.json")
    csvs = {k: os.path.join(tmp, f"solution_fi_{k}.csv") for k in ("host", "roi", "int8")}
    with open(conf_path, "w") as f:
        json.dump({
            "fi_conf": {"raw_data_path": root, "test_path": train_dir,
                        "output_file_path": csvs["host"], "model_loading": True,
                        "model_path": fi_ckpt, "hps": {"sim_th": FI_SIM_TH},
                        "nn_arch": {"image_size": S, "dense1_dim": 64}},
            "fd_conf": {"model_loading": True, "model_path": fd_ckpt,
                        "int8_pallas_blocks": True, "int8_tail_auto": False,
                        "hps": {"face_conf_th": 0.05, "batch_size": 8},
                        "nn_arch": {"image_size": S}},
        }, f)

    # Hand-made boxes: each image's face box jittered, two random boxes, one
    # with a corner at 0 (the slice wraps) and a zero-size one.
    brng = np.random.default_rng(SEED + 9)
    names = sorted(gt["FILE"])[:FI_ROI_IMAGES]
    images = [imread(os.path.join(train_dir, n)) for n in names]
    boxes_list = []
    for n in names:
        x, y, w, h = gt.loc[gt["FILE"] == n, ["FACE_X", "FACE_Y", "FACE_WIDTH",
                                              "FACE_HEIGHT"]].iloc[0]
        rows = [[x + brng.uniform(-6, 6), y + brng.uniform(-6, 6),
                 x + w + brng.uniform(-6, 6), y + h + brng.uniform(-6, 6)]
                for _ in range(FI_ROI_BOXES - 4)]
        for _ in range(2):
            x0, y0 = brng.uniform(0, S * 0.7, 2)
            rows.append([x0, y0, x0 + brng.uniform(S * 0.05, S * 0.3),
                         y0 + brng.uniform(S * 0.05, S * 0.3)])
        rows += [[0.0, y, x + w, y + h], [x, y, x, y]]
        bx = np.clip(np.asarray(rows, np.float64), 0, S)
        boxes_list.append(np.concatenate([bx, brng.uniform(0.05, 1, (len(rows), 1))], 1))

    # ---- the main path: counts zeroed just before, read just after.
    kernel_fns = (nms_sweep, conv_int8, block_int8, fused_front)
    cwd = os.getcwd()
    os.chdir(root)  # the subject DB's CSV, h5 and pickles land in the working directory
    try:
        for k in kernel_fns:
            k.launches = 0
        t0 = time.perf_counter()
        assert fim.main([f"--conf={conf_path}", "fi_conf.mode=data"]) is None
        if HAVE_H5PY:
            fi = fim.main([f"--conf={conf_path}", "fi_conf.mode=fid_db"])
        else:
            print("[identify] h5py is not installed on this machine: mode=fid_db "
                  "(it writes subject_facial_ids.h5) is skipped; the registry embeds "
                  "the same subject faces")
            fi = fim.FaceIdentifierPipeline(load_conf(conf_path))
        registry = fi.register_facial_ids()
        fim.main([f"--conf={conf_path}", "fi_conf.mode=test"])
        fim.main([f"--conf={conf_path}", "fi_conf.mode=test", "fi_conf.device_roi=true",
                  f"fi_conf.output_file_path={csvs['roi']}"])
        subject_ids, reg = fi._load_registry()
        reg_dev = torch.from_numpy(reg).to(dev)
        host_rows = [fi._identify_image(im, bx, subject_ids, reg)
                     for im, bx in zip(images, boxes_list)]
        roi_rows = fi._identify_chunk_device(images, boxes_list, subject_ids, reg_dev)
        conf8 = load_conf(conf_path)
        conf8.fi_conf.output_file_path = csvs["int8"]
        fi8 = fim.FaceIdentifierPipeline(conf8, precision="int8")
        fi8.test()
        rows8 = fi8._identify_chunk_device(images, boxes_list, subject_ids, reg_dev)
        fib = fim.FaceIdentifierPipeline(load_conf(conf_path), precision="bfloat16")
        rowsb = fib._identify_chunk_device(images, boxes_list, subject_ids, reg_dev)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernel_fns}
        main_s = time.perf_counter() - t0
        db = pd.read_csv("subject_image_db.csv")
    finally:
        os.chdir(cwd)
    sol = {k: [r.split(",") for r in open(v).read().splitlines()] for k, v in csvs.items()}
    n_rows = {k: len(v) for k, v in sol.items()}
    print(f"[identify] data + {'fid_db + ' if HAVE_H5PY else ''}registry ({len(db)} "
          f"subject faces, {len(registry)} "
          f"subjects) + test mode (f32 host crops, f32 device_roi, int8) through the CLI, "
          f"hand-made boxes ({sum(len(b) for b in boxes_list)} on {len(images)} images) at "
          f"f32 (host and device crops), int8 and bf16, {S}² on {card}: {main_s:.1f} s; "
          f"solution_fi.csv rows {n_rows}, subject ids of the device_roi CSV equal to "
          f"the host one's on {sum(a[1] == b[1] for a, b in zip(sol['roi'], sol['host']))}; "
          f"launches {launches}")
    if min(launches[k] for k in ("nms_sweep", "conv_int8", "block_int8")) == 0:
        raise AssertionError(f"[identify] the FI path skipped a kernel: {launches}")
    if len(db) != FI_SUBJECTS * FI_TRAIN_PER_SUBJ or len(registry) != FI_SUBJECTS:
        raise AssertionError("[identify] the subject DB is incomplete")
    # The two crop paths write the same rows (files, boxes, scores); their
    # subject ids are held below on hand-made boxes, where ties are visible.
    if [r[:1] + r[2:] for r in sol["roi"]] != [r[:1] + r[2:] for r in sol["host"]]:
        raise AssertionError("[identify] the device_roi CSV's rows differ from the host one's")

    # ---- reproducibility of the int8 CLI test above: a second pipeline from
    # the same conf, seeds, tree and file order must write the same rows.
    # (int8 calibrates on the first batch or crops in the order glob returns
    # the files, which the file system decides, as in the JAX package.)
    repeat_csv = os.path.join(tmp, "solution_fi_int8_repeat.csv")
    os.chdir(root)
    try:
        conf_r = load_conf(conf_path)
        conf_r.fi_conf.output_file_path = repeat_csv
        fim.FaceIdentifierPipeline(conf_r, precision="int8").test()
    finally:
        os.chdir(cwd)
    again = open(repeat_csv).read().splitlines()
    first = open(csvs["int8"]).read().splitlines()
    print(f"[identify] int8 CLI test run again from the same seeds and file order: "
          f"{len(again)} rows vs {len(first)}, equal row by row {again == first}")
    if again != first:
        raise AssertionError("[identify] the int8 CLI test is not reproducible from the "
                             "same seeds and file order")

    # ---- card vs CPU port on the hand-made boxes, f32.
    fi_cpu = fim.FaceIdentifierPipeline(load_conf(conf_path), device="cpu")
    cpu_rows = [fi_cpu._identify_image(im, bx, subject_ids, reg)
                for im, bx in zip(images, boxes_list)]
    crops, crops32 = [], []
    for im, bx in zip(images, boxes_list):
        for b in bx:
            l, t, r, bb = (int(v) for v in b[:4])
            c = im[(t - 1):(bb - 1), (l - 1):(r - 1)]
            if c.shape[0] and c.shape[1]:
                crops.append(letterbox_host(c / 255, S, "cubic")[0])
                crops32.append(letterbox_host((c / 255).astype(np.float32), S, "cubic")[0])
    crops = np.asarray(crops, np.float32)
    e_card = fi.embed_device(crops)
    e_cpu = fi_cpu.embed_device(crops)
    reg_cpu = torch.from_numpy(reg)
    i_card, d_card = match_embeddings(e_card, reg_dev)
    i_cpu, d_cpu = match_embeddings(e_cpu, reg_cpu)
    emb_err = float((e_card.cpu() - e_cpu).abs().max())
    dist_err = float((d_card.cpu() - d_cpu).abs().max())
    flat = [r for rows in host_rows for r in rows]
    flat_cpu = [r for rows in cpu_rows for r in rows]
    same_ids = [a["subject_id"] == b["subject_id"] for a, b in zip(flat, flat_cpu)]
    print(f"[identify] f32 host crops, card vs CPU port: {len(flat)} rows vs "
          f"{len(flat_cpu)}, subject ids equal on {sum(same_ids)}; embeddings max |diff| "
          f"{emb_err:.3g}, registry distances {dist_err:.3g} (tol {FI_DIST_TOL})")
    if ([(a["box_index"], a["xmin"]) for a in flat] != [(b["box_index"], b["xmin"])
                                                        for b in flat_cpu]
            or len(flat) != len(crops) or dist_err > FI_DIST_TOL
            or not _tie_ok(i_card.cpu(), e_cpu, reg_cpu)):
        raise AssertionError("[identify] the card's identify rows disagree with the CPU's")

    # Device crops (ops/roi.py on the card) vs the host crops.
    owners, plan = fi._roi_plan(images, boxes_list)
    d_crops = fi._roi_crops(plan, slice(0, len(owners)))
    crop_err = float((d_crops.cpu() - torch.from_numpy(np.asarray(crops32))).abs().max())
    crop_err64 = float((d_crops.cpu() - torch.from_numpy(crops)).abs().max())
    flat_roi = [r for rows in roi_rows for r in rows]
    e_roi = fi.embed_device(d_crops)
    i_roi, _ = match_embeddings(e_roi, reg_dev)
    print(f"[identify] device_roi crops on the card vs cv2 on the same crops: {len(owners)} "
          f"ROIs, max |diff| {crop_err:.3g} as f32 pixels (tol {FI_CROP_TOL}), "
          f"{crop_err64:.3g} as the host path's f64 pixels (tol {FI_CROP_F64_TOL}); "
          f"device-ROI rows {len(flat_roi)}, "
          f"subject ids equal to the host path's on "
          f"{sum(a['subject_id'] == b['subject_id'] for a, b in zip(flat_roi, flat))}")
    if (crop_err > FI_CROP_TOL or crop_err64 > FI_CROP_F64_TOL
            or [r["box_index"] for r in flat_roi] != [r["box_index"]
                                                                         for r in flat]
            or not _tie_ok(i_roi.cpu(), e_card.cpu(), reg_cpu)):
        raise AssertionError("[identify] device-ROI crops or rows disagree with the host path")

    # int8: the embed trunk (A0 on every conv) on the card vs the CPU plain
    # path, on the same qparams: an integer program, so bit-identical.
    q_card = fi8._q_embed
    q_cpu = quant.to_device(q_card, "cpu")
    x8 = d_crops[:FI_INT8_CHECK_B]
    with torch.inference_mode():
        t_card = quant.apply_graph_quant(q_card, x8, ops, fused_blocks=False)["trunk"]
        t_cpu = quant.apply_graph_quant(q_cpu, x8.cpu(), ops, fused_blocks=False)["trunk"]
    torch.cuda.synchronize()
    flat8 = [r for rows in rows8 for r in rows]
    print(f"[identify] int8 embed trunk (13x13x1024) on {x8.shape[0]} crops, card vs CPU "
          f"plain path: torch.equal {torch.equal(t_card.cpu(), t_cpu)}, "
          f"{float((t_cpu != 0).float().mean()):.1%} non-zero; int8 rows {len(flat8)}, "
          f"subject ids equal to f32's on "
          f"{sum(a['subject_id'] == b['subject_id'] for a, b in zip(flat8, flat_roi))}")
    if not torch.equal(t_card.cpu(), t_cpu):
        raise AssertionError("[identify] the int8 embed trunk differs between card and CPU")
    # bf16: the folded trunk with the f32 front guard (bf16_f32_front 2).
    e_b = fib.embed_device(d_crops)
    b_err = float((e_b - e_roi).abs().max())
    norm_err = float((e_b.norm(dim=1) - 1).abs().max())
    flatb = [r for rows in rowsb for r in rows]
    print(f"[identify] bf16 embed, f32 front guard {fib.conf.bf16_f32_front}: max |diff| "
          f"to f32 {b_err:.3g} (unit vectors), | |e| - 1 | {norm_err:.2g}; bf16 rows "
          f"{len(flatb)}, subject ids equal to f32's on "
          f"{sum(a['subject_id'] == b['subject_id'] for a, b in zip(flatb, flat_roi))}")
    if int(fib.conf.bf16_f32_front) != 2 or norm_err > 1e-3 or not torch.isfinite(e_b).all():
        raise AssertionError("[identify] the bf16 embed is off")
    del fi_cpu, q_cpu, t_card, t_cpu
    torch.cuda.empty_cache()

    # ---- timings: embed img/s at FI_EMBED_B crops, ms per identified chunk.
    rates = {}
    reps = -(-FI_EMBED_B // len(owners))
    x64 = torch.cat([d_crops] * reps)[:FI_EMBED_B].contiguous()
    for label, pipe in (("f32", fi), ("bf16", fib), ("int8", fi8)):
        ms = cuda_ms(lambda: pipe._embed_tensor(x64), 5, warmup=2)
        rates[f"embed_img_s_{label}"] = FI_EMBED_B / (np.median(ms) / 1e3)
        print(f"[identify] embed {label} b={FI_EMBED_B} at {S}² on {card}: "
              f"{rates[f'embed_img_s_{label}']:.1f} img/s; {quartiles(ms)}")
    for label, pipe in (("f32", fi), ("int8", fi8)):
        ms = cuda_ms(lambda: pipe._identify_chunk_device(images, boxes_list, subject_ids,
                                                         reg_dev), 5, warmup=1)
        rates[f"roi_chunk_ms_{label}"] = float(np.median(ms))
        print(f"[identify] device-ROI identify of one chunk ({len(images)} images, "
              f"{len(owners)} ROIs: crops, embed, match, rows) {label} on {card}: "
              f"{quartiles(ms)}")
    del x64, fi8, fib
    torch.cuda.empty_cache()

    # ---- triplet training.
    os.chdir(root)
    try:
        ds = facedb.TripletDataset(root, rng=np.random.default_rng(SEED),
                                   shuffle_rng=random.Random(SEED),
                                   pairs_pickle=os.path.join(tmp, "fi_pairs.pickle"))
        sd = load_checkpoint(fi_ckpt)
        res = {}
        a, p, n = ds.batch(0, 2)
        w = torch.ones(2)
        for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
            model = fi.model if name == "card" else FaceIdentifierModel(image_size=S,
                                                                        device="cpu")
            pp, ss = darknet.split_state_dict({k: v.to(device) for k, v in sd.items()})
            leaves = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
            out, _ = model.triplet_forward(leaves, ss, *(torch.from_numpy(v).to(device)
                                                         for v in (a, p, n)))
            loss = triplet_step_loss(out, w.to(device), 64)
            loss.backward()
            res[name] = (float(loss.detach()), {k: v.grad.cpu() for k, v in leaves.items()})
            del leaves, out, loss
        (lc, gc), (lh, gh) = res["card"], res["cpu"]
        g_tot = sum(float(g.norm()) ** 2 for g in gh.values()) ** 0.5
        g_diff = sum(float((gc[k] - g).norm()) ** 2 for k, g in gh.items()) ** 0.5
        print(f"[identify] one f32 triplet step at b2 ({S}², 6 images), card vs CPU port "
              f"on {card}: loss {lc:.6f} vs {lh:.6f} (|diff| {abs(lc - lh):.2g}, tol "
              f"{FI_STEP_LOSS_ATOL}); gradients {g_diff / g_tot:.2g} of their norm "
              f"{g_tot:.4g} (tol {STEP_GRAD_TOL})")
        if abs(lc - lh) > FI_STEP_LOSS_ATOL or g_diff > STEP_GRAD_TOL * g_tot:
            raise AssertionError("[identify] the card's triplet step disagrees with the CPU's")
        del res, gc, gh
        torch.cuda.empty_cache()

        trained = {}
        for label, precision, mining, b, epochs in FI_TRAIN_RUNS:
            conf = load_conf(conf_path)
            c = conf.fi_conf
            c.hps.batch_size, c.hps.epochs, c.hps.lr = b, epochs, FI_TRAIN_LR
            c.negative_mining = mining
            pipe = fim.FaceIdentifierPipeline(conf, precision=precision, seed=SEED)
            c.model_path = os.path.join(tmp, f"fi_trained_{label}.pt")
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pipe.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            hist = [json.loads(line)["loss"] for line in open(c.model_path + "_history.jsonl")]
            steps = len(hist) // epochs
            first, last = np.mean(hist[:steps]), np.mean(hist[-steps:])
            print(f"[identify] triplet training {label} ({precision}, {mining}) b={b} "
                  f"({3 * b} images a step), {epochs} epochs of {steps} steps on "
                  f"{len(ds)} triplets, {card}: epoch mean loss {first:.5f} -> {last:.5f} "
                  f"(steps {', '.join(f'{v:.4f}' for v in hist)}); {wall:.1f} s with "
                  f"finalize_bn and the save; peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
            if not np.isfinite(hist).all() or (epochs > 1 and not last < first):
                raise AssertionError(f"[identify] {label}: the triplet loss did not fall "
                                     f"({first} -> {last})")
            trained[label] = pipe
            torch.cuda.empty_cache()

        # triplets/s: the step on device-resident batches.
        for label, dtype, b in (("bf16", torch.bfloat16, 32), ("f32", torch.float32, 8)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            pp, ss = darknet.split_state_dict({k: v.to(dev) for k, v in sd.items()})
            opt = optimizer.KerasAdam(FI_TRAIN_LR)
            step = trainer.make_triplet_step(fi.model, opt, compute_dtype=dtype)
            apn = [torch.from_numpy(v).to(dev).to(dtype) for v in ds.batch(0, b)]
            carry = [pp, ss, opt.init(pp)]
            wb = torch.ones(b, device=dev)

            def run():
                carry[0], carry[1], carry[2], _ = step(*carry, *apn, wb)

            ms = cuda_ms(run, FI_TIMING_STEPS, warmup=2)
            rates[f"triplets_s_{label}_b{b}"] = b / (np.median(ms) / 1e3)
            rates[f"train_peak_gib_{label}_b{b}"] = torch.cuda.max_memory_allocated() / 2**30
            print(f"[identify] triplets/s {label} b={b} ({3 * b} images a step) at {S}² "
                  f"on {card}: {rates[f'triplets_s_{label}_b{b}']:.1f} triplets/s "
                  f"({3 * rates[f'triplets_s_{label}_b{b}']:.1f} img/s); step "
                  f"{quartiles(ms)}; peak {rates[f'train_peak_gib_{label}_b{b}']:.1f} GiB")
            del carry, apn, step
        torch.cuda.empty_cache()

        # Held-out top-1: registries from the untrained and the bf16-trained
        # embedders (printed, not gated: a few epochs on a few identities).
        h_crops, h_sids = synthetic.holdout_crops(holdout, S)
        for label, pipe in (("untrained f32", fi), ("bf16-trained", trained["bf16"])):
            reg_t = pipe.register_facial_ids()
            sids = list(reg_t)
            idx, _ = match_embeddings(pipe.embed_device(h_crops),
                                      torch.from_numpy(np.asarray([reg_t[s] for s in sids],
                                                                  np.float32)))
            top1 = float(np.mean(np.asarray([sids[int(i)] for i in idx.cpu()]) == h_sids))
            rates[f"heldout_top1_{label.split()[0].replace('-', '_')}"] = top1
            print(f"[identify] held-out top-1, {label}: {top1:.3f} on {len(h_sids)} faces "
                  f"of {FI_SUBJECTS} subjects (chance {1 / FI_SUBJECTS:.3f}; not gated)")
    finally:
        os.chdir(cwd)
    return launches, rates


def coco_phase(tmp, card, dev):
    """The COCO demo on the card (phase 12): the main path through the
    entry points a user calls (the `-w` CLI at each precision on two JPEGs,
    `-s`/`-l` where h5py is installed, the legacy `--mode test` CLI and FI
    `reconstruct` at 416² on RECON_IDS ids), with the launch counts zeroed
    before it and read after it; then each kernel against its plain version
    at this path's shapes (A0 at every conv of the graph that the face
    trunk lacks: the 255-channel heads, the 768/384-channel concat inputs;
    A at b=1; B on the (80, 256) class batch of a real decode, and with
    infinite and zero-area boxes put in), the three int8 heads card vs CPU
    with the blocks on and off, the f32 heads card vs CPU, reconstruct card
    vs CPU; then detect_coco ms per image on a device-resident input (and
    its device time by kernel family), its launches per int8 image, B at
    (80, 256) and reconstruct ms. Returns
    (launches, {metric: value})."""
    import argparse

    from face_vijnana_yolov3_tpu_torch.api import face_detection as fdm
    from face_vijnana_yolov3_tpu_torch.api import face_identification as fim
    from face_vijnana_yolov3_tpu_torch.api import yolov3_detect as yd
    from face_vijnana_yolov3_tpu_torch.api.config import Conf
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import save_checkpoint
    from face_vijnana_yolov3_tpu_torch.core.weights import save_darknet_weights
    from face_vijnana_yolov3_tpu_torch.models import darknet, quant
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
    from face_vijnana_yolov3_tpu_torch.models.recon import FaceReconstructionModel
    from face_vijnana_yolov3_tpu_torch.ops.block_int8 import block_int8, block_int8_reference
    from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import conv_int8, conv_int8_reference
    from face_vijnana_yolov3_tpu_torch.ops.front_fused import fused_front
    from face_vijnana_yolov3_tpu_torch.ops.nms import class_batch
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import nms_sweep, nms_sweep_reference
    from face_vijnana_yolov3_tpu_torch.ops.postprocess import (
        coco_candidates,
        coco_postprocess,
    )

    S = COCO_SIZE
    root = os.path.join(tmp, "coco")
    os.makedirs(root)
    ops = darknet.yolov3_graph()
    params, state = darknet.init_graph_params(ops, SEED + 20)
    darknet.perturb_batchnorm(params, state, ops, SEED + 21)
    hrng = np.random.default_rng(SEED + 22)
    for idx in (81, 93, 105):  # live head biases (the init gives zeros)
        params[f"conv_{idx}"]["bias"] = hrng.normal(0, 0.5, 255).astype(np.float32)
    sd = params_from_jax(params, state)
    del params, state
    n_params = sum(v.numel() for k, v in sd.items() if not k.endswith((".mean", ".var")))
    weights = os.path.join(root, "yolov3.weights")
    save_darknet_weights(weights, sd, ops)
    jrng = np.random.default_rng(SEED + 23)
    jpegs = []
    for i, (h, w) in enumerate(COCO_JPEGS):
        fn = os.path.join(root, f"coco_{i}.jpg")
        Image.fromarray(jrng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(fn)
        jpegs.append(fn)
    legacy_dir = os.path.join(root, "legacy")
    os.makedirs(legacy_dir)
    legacy_files = write_images(legacy_dir, jrng)
    fd_model = FaceDetectorModel(image_size=IMAGE_SIZE, device="cpu")
    fparams, fstate = fd_model.init_params(SEED)
    darknet.perturb_batchnorm(fparams, fstate, fd_model.ops, SEED + 1)
    fd_sd = params_from_jax(fparams, fstate)
    del fd_model, fparams, fstate
    fd_pt = os.path.join(root, "face_detector.pt")
    save_checkpoint(fd_pt, fd_sd)
    if HAVE_H5PY:  # the legacy CLI's artifact, read from the working directory
        from face_vijnana_yolov3_tpu_torch.core.keras_import import save_detector_keras_h5

        save_detector_keras_h5(fd_sd, os.path.join(root, "face_detector.hd5"))
    legacy_csv = os.path.join(root, "solution_fd_legacy.csv")
    legacy_flags = {"mode": "test", "raw_data_path": legacy_dir,
                    "output_file_path": legacy_csv, "image_size": str(IMAGE_SIZE),
                    "num_filters": "6", "lr": "0.001", "beta_1": "0.99", "beta_2": "0.99",
                    "decay": "0.0", "step_per_epoch": "1", "epochs": "1",
                    "face_conf_th": "0.05", "nms_iou_th": "0.5", "num_cands": "60",
                    "model_loading": "1"}
    conf_fi = Conf()
    conf_fi.fi_conf.weights_path = conf_fi.fd_conf.weights_path = "missing.weights"
    conf_fi.fi_conf.nn_arch.image_size = conf_fi.fd_conf.nn_arch.image_size = S
    ids = np.random.default_rng(SEED + 24).normal(
        size=(RECON_IDS, conf_fi.fi_conf.nn_arch.dense1_dim)).astype(np.float32)

    # ---- the main path: counts zeroed just before, read just after.
    kernel_fns = (nms_sweep, conv_int8, block_int8, fused_front)
    cwd = os.getcwd()
    os.chdir(root)  # -s/-l's yolov3_model.h5, the legacy artifact, the decoder's .pt
    try:
        for k in kernel_fns:
            k.launches = 0
        t0 = time.perf_counter()
        cli_s = collections.defaultdict(list)
        for precision in COCO_PRECISIONS:
            for fn in jpegs:
                t1 = time.perf_counter()
                out = yd.main(["-w", weights, "-i", fn, "--precision", precision])
                torch.cuda.synchronize()
                cli_s[precision].append(time.perf_counter() - t1)
                if imread(out).shape != imread(fn).shape:
                    raise AssertionError(f"[coco] {out}: not the input's shape")
                os.replace(out, out.replace("_detected", f"_detected_{precision}"))
        if HAVE_H5PY:
            yd.main(["-w", weights, "-i", jpegs[0], "-s", "1"])
            yd.main(["-l", "1", "-i", jpegs[0]])
            print("[coco] -s wrote yolov3_model.h5 and -l ran from it")
        else:
            print("[coco] h5py is not installed on this machine: the -s/-l runs "
                  "(yolov3_model.h5) are skipped; the CPU tests drive them")
        if HAVE_H5PY:
            fdm.main([a for k, v in legacy_flags.items() for a in (f"--{k}", v)])
        else:
            conf_l = fdm.legacy_args_to_conf(argparse.Namespace(**legacy_flags))
            print(f"[coco] h5py is not installed: legacy_args_to_conf built the --mode "
                  f"test conf (model {conf_l.model_path}, face-region ratio "
                  f"{conf_l.apply_face_region_ratio}); it serves from {os.path.basename(fd_pt)} "
                  f"instead of the .hd5 artifact")
            conf_l.model_path = fd_pt
            fdm.FaceDetectorPipeline(conf_l).test()
        fi = fim.FaceIdentifierPipeline(conf_fi)
        rec = fi.reconstruct(ids)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernel_fns}
        main_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    legacy_summary = check_csv(legacy_csv, len(legacy_files), "legacy --mode test")
    print(f"[coco] YOLOv3-{S} ({n_params / 1e6:.1f} M parameters), the -w CLI at "
          f"{', '.join(COCO_PRECISIONS)} on {len(jpegs)} JPEGs (h, w) {COCO_JPEGS}, the "
          f"legacy --mode test CLI ({legacy_summary}), reconstruct of {RECON_IDS} ids "
          f"at {S}² {rec.shape} on {card}: {main_s:.1f} s; CLI wall s a run "
          f"{ {p: [round(t, 2) for t in v] for p, v in cli_s.items()} }; launches {launches}")
    if min(launches[k] for k in ("nms_sweep", "conv_int8", "block_int8")) == 0:
        raise AssertionError(f"[coco] the COCO path skipped a kernel: {launches}")
    if rec.shape != (RECON_IDS, S, S, 3) or not np.isfinite(rec).all():
        raise AssertionError("[coco] reconstruct gave no finite images")

    # ---- A0 at the graph's new shapes and A at b=1, vs their plain versions.
    rng = np.random.default_rng(SEED + 25)
    trunk = set(trunk_int8_calls(darknet.trunk_graph(), S, True)
                + trunk_int8_calls(darknet.trunk_graph(), S, False))
    calls = trunk_int8_calls(ops, S, True)
    new_convs = sorted({c[1:] for c in calls if c[0] == "conv" and c not in trunk})
    conv_cases = [(1, c) for c in new_convs] + [
        (3, (*RAGGED_HW, *c[2:])) for c in new_convs if c[3] == 255]
    err = {"conv_int8": 0, "block_int8": 0}
    for b, shape in conv_cases:
        a = int8_conv_operands(b, *shape, rng)
        leaky = shape[3] != 255  # the heads are linear
        got = conv_int8(a["x_q"], a["w_q"], a["w_scale"], a["bias"], a["inv_out"],
                        stride=shape[5], leaky=leaky)
        want = conv_int8_reference(a["x_q"], a["w_q"], a["w_scale"], a["bias"],
                                   a["inv_out"], stride=shape[5], leaky=leaky)
        torch.cuda.synchronize()
        err["conv_int8"] = max(err["conv_int8"], int((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"[coco] conv_int8 != plain version at b={b} {shape}")
    for shape in sorted({c[1:] for c in calls if c[0] == "block"}):
        args = int8_block_operands(1, *shape, rng)
        got, want = block_int8(*args), block_int8_reference(*args)
        torch.cuda.synchronize()
        err["block_int8"] = max(err["block_int8"], int((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"[coco] block_int8 != plain version at b=1 {shape}")
    print(f"[coco] conv_int8 vs plain at the {len(new_convs)} conv shapes the face trunk "
          f"lacks (b=1; the 255-channel heads linear, also ragged {RAGGED_HW} at b=3) and "
          f"block_int8 at b=1: torch.equal in all {len(conv_cases)} + "
          f"{len({c[1:] for c in calls if c[0] == 'block'})} cases")

    # ---- the graph: int8 card (blocks on, off) vs CPU, f32 card vs CPU.
    image = imread(jpegs[1])
    x = torch.from_numpy(yd.preprocess_coco(image, S, S)).to(dev)
    sd_dev = {k: v.to(dev) for k, v in sd.items()}
    with torch.inference_mode():
        qp = quant.to_device(quant.quantize_folded(darknet.fold_graph_params(sd_dev, ops),
                                                   x, ops), dev)
        on = quant.apply_graph_quant(qp, x, ops, fused_blocks=True)
        off = quant.apply_graph_quant(qp, x, ops, fused_blocks=False)
        t0 = time.perf_counter()
        cpu8 = quant.apply_graph_quant(quant.to_device(qp, "cpu"), x.cpu(), ops,
                                       fused_blocks=True)
        cpu8_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    same8 = {k: (torch.equal(on[k], off[k]), torch.equal(on[k].cpu(), cpu8[k]))
             for k in yd.YOLO_OUTPUTS}
    live = {k: float((cpu8[k] != 0).float().mean()) for k in yd.YOLO_OUTPUTS}
    print(f"[coco] int8 heads at {S}², blocks on == off and card == CPU plain path "
          f"(CPU {cpu8_s:.1f} s): {same8}; non-zero shares {live}")
    if not all(a and b for a, b in same8.values()):
        raise AssertionError("[coco] the int8 heads differ (blocks on/off or card/CPU)")
    f32_card = yd.coco_forward(sd_dev, "float32", dev)(x)
    f32_cpu = yd.coco_forward(sd, "float32", "cpu")(x.cpu())
    f32_err = max(float((a.cpu() - b).abs().max() / b.abs().max())
                  for a, b in zip(f32_card, f32_cpu))
    print(f"[coco] f32 heads card vs CPU: max |diff| {f32_err:.3g} of max |head| "
          f"(tol {HEAD_TOL})")
    if not f32_err <= HEAD_TOL:
        raise AssertionError("[coco] the card's f32 heads disagree with the CPU's")

    # ---- B on the (80, 256) class batch of the card's f32 decode, and with
    # infinite and zero-area boxes put into it.
    h, w = image.shape[:2]
    with torch.inference_mode():
        boxes_k, _obj, classes_k, valid = coco_candidates(
            tuple(t[0] for t in f32_card), h, w, net_h=S, net_w=S)
        b_sorted, s_sorted, _order = class_batch(boxes_k, classes_k)
        odd = boxes_k.clone()
        odd[::7, 2] = torch.inf
        odd[3::11, 0] = -torch.inf
        odd[5::13, 2:] = odd[5::13, :2]  # zero area
        b_odd, s_odd, _ = class_batch(odd, classes_k)
    nms_err = 0.0
    for bb, ss in ((b_sorted, s_sorted), (b_odd, s_odd)):
        got = nms_sweep(bb, ss, COCO_NMS_TH)
        want = nms_sweep_reference(bb, ss, COCO_NMS_TH)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("[coco] nms_sweep != plain version on the class batch")
        nms_err = max(nms_err, float((got - want).abs().max()))
    kept = nms_sweep(b_sorted, s_sorted, COCO_NMS_TH) > 0
    n = s_sorted.shape[1]
    pairs = int((kept * (n - 1 - torch.arange(n, device=dev))).sum())
    nms_bound, nms_bound_by = bound(s_sorted.numel() * (16 + 4 + 4),
                                    NMS_OPS_PER_PAIR * pairs + NMS_OPS_PER_BOX * s_sorted.numel(),
                                    PEAK_F32)
    nms_ms = graph_ms(lambda: nms_sweep(b_sorted, s_sorted, COCO_NMS_TH))
    nms_plain = cuda_ms(lambda: nms_sweep_reference(b_sorted, s_sorted, COCO_NMS_TH), 5)
    print(f"[coco] nms_sweep on the {tuple(s_sorted.shape)} class batch ({int(valid.sum())} "
          f"candidates through the gate; and with infinite and zero-area boxes): torch.equal "
          f"with the plain version; {card}: kernel {quartiles(nms_ms)} on the device, plain "
          f"{quartiles(nms_plain)}, bound {nms_bound * 1e3:.3f} us by {nms_bound_by} "
          f"({pairs} IoU tests)")

    # ---- reconstruct, card vs CPU on the same decoder.
    cpu_rm = FaceReconstructionModel(image_size=S, device="cpu")
    cpu_rm.load_state_dict({k: v.cpu() for k, v in fi.recon_model.state_dict().items()})
    with torch.inference_mode():
        rec_cpu = cpu_rm(torch.from_numpy(ids)).numpy()
    rec_err = float(np.abs(rec - rec_cpu).max() / np.abs(rec_cpu).max())
    print(f"[coco] reconstruct {rec.shape} card vs CPU: max |diff| {rec_err:.3g} of max "
          f"|output| {float(np.abs(rec_cpu).max()):.4g} (tol {RECON_TOL})")
    if not rec_err <= RECON_TOL:
        raise AssertionError("[coco] the card's reconstruction disagrees with the CPU's")
    del cpu_rm, f32_cpu, cpu8

    # ---- timings on a device-resident input, after warm-up.
    metrics = {"cli_s": {p: float(np.mean(v)) for p, v in cli_s.items()},
               "nms_ms_80x256": float(np.median(nms_ms)),
               "nms_plain_ms_80x256": float(np.median(nms_plain)),
               "nms_bound_ms_80x256": nms_bound, "nms_bound_by_80x256": nms_bound_by,
               "max_abs_err": {**err, "nms_sweep": nms_err}}
    metrics.update(coco_programs(root, weights, jpegs, card, dev))
    for precision in COCO_PRECISIONS:
        program = yd.coco_forward(sd_dev, precision, dev, x_calib=x)

        def detect(program=program):
            with torch.inference_mode():
                return coco_postprocess(tuple(t[0] for t in program(x)), h, w,
                                        nms_th=COCO_NMS_TH, net_h=S, net_w=S)

        ms = cuda_ms(detect, COCO_TIMING_REPS, warmup=2)
        metrics[f"detect_ms_{precision}"] = float(np.median(ms))
        split = profile_split(detect, 3)
        metrics[f"detect_device_ms_{precision}"] = sum(split.values())
        if precision == "int8":
            for k in kernel_fns:
                k.launches = 0
            detect()
            torch.cuda.synchronize()
            metrics["int8_launches_per_image"] = {k.__name__: k.launches for k in kernel_fns}
        print(f"[coco] detect_coco {precision} at {S}² (forward + postprocess of one "
              f"device-resident image; int8 calibrated once, before) on {card}: "
              f"{quartiles(ms)}; device ms by kernel family (torch.profiler) "
              f"{ {k: round(v, 4) for k, v in split.items()} }, "
              f"{sum(split.values()):.3f} in all, busy "
              f"{sum(split.values()) / np.median(ms):.1%}")
        del program
    # The JAX demo runs its int8 graph with the blocks off and its NMS in
    # XLA; the port turns kernel A on. Time both at b=1 on the same qparams,
    # alternated: on, off, on, off.
    blocks_ms = collections.defaultdict(list)
    for blocks in (True, False, True, False):
        def detect8(blocks=blocks):
            with torch.inference_mode():
                outs = quant.apply_graph_quant(qp, x, ops, fused_blocks=blocks)
                return coco_postprocess(tuple(outs[k][0] for k in yd.YOLO_OUTPUTS), h, w,
                                        nms_th=COCO_NMS_TH, net_h=S, net_w=S)

        blocks_ms["on" if blocks else "off"] += cuda_ms(detect8, COCO_TIMING_REPS, warmup=2)
        if blocks:
            detect8_on = detect8
    for k, v in blocks_ms.items():
        metrics[f"detect_ms_int8_blocks_{k}"] = float(np.median(v))
    print(f"[coco] detect_coco int8 at {S}², b=1, blocks on vs off (alternated) on {card}: "
          f"on {quartiles(blocks_ms['on'])}, off {quartiles(blocks_ms['off'])}")
    z = torch.from_numpy(ids).to(dev)
    with torch.inference_mode():
        ms = cuda_ms(lambda: fi.recon_model(z), 5, warmup=2)
    metrics["reconstruct_ms"] = float(np.median(ms))
    print(f"[coco] reconstruct {RECON_IDS} ids at {S}² on {card}: {quartiles(ms)}; int8 "
          f"launches per image {metrics['int8_launches_per_image']}")
    per = metrics["int8_launches_per_image"]
    if per["conv_int8"] != 35 or per["block_int8"] != 20 or per["nms_sweep"] != 1:
        raise AssertionError(f"[coco] int8 launches per image {per}, expected 35 / 20 / 1")
    del fi, sd_dev  # qp lives on in the returned detect8
    torch.cuda.empty_cache()
    return launches, metrics, detect8_on

def coco_programs(root, weights, jpegs, card, dev) -> dict:
    """The COCO demo's programs (phase 12): `YOLOV3` at f32 and bf16 over
    the two JPEGs twice each and a second image of the first one's shape
    (detect_person, which replays one program per image shape and
    thresholds), the launch counts zeroed just before and read just after
    (B must move: `launches_coco_replay`); the second image must reuse its
    key. Then each replay `torch.equal` to the eager program on the same
    device input, and ms an image eager vs replay on a device-resident
    input with the busy share of each."""
    from face_vijnana_yolov3_tpu_torch import kernels
    from face_vijnana_yolov3_tpu_torch.api import yolov3_detect as yd
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import nms_sweep
    from face_vijnana_yolov3_tpu_torch.ops.postprocess import coco_postprocess

    S = COCO_SIZE
    h0, w0 = COCO_JPEGS[0]
    twin = os.path.join(root, "coco_twin.jpg")
    Image.fromarray(np.random.default_rng(SEED + 26).integers(
        0, 256, (h0, w0, 3), dtype=np.uint8)).save(twin)
    images = [imread(f) for f in (*jpegs, *jpegs, twin)]
    kw = dict(obj_thresh=0.5, cls_thresh=0.0, nms_thresh=COCO_NMS_TH,
              human_entropy_thresh=100.0, bottle_entropy_thresh=100.0)
    metrics = {}
    for precision in ("float32", "bfloat16"):
        model = yd.YOLOV3(weights, precision=precision, net_size=S, device=dev)
        # The path: counts zeroed just before it, read just after it.
        for k in kernels.LAUNCH_COUNTERS:
            k.launches = 0
        t0 = time.perf_counter()
        for image in images[:-1]:
            model.detect_person(image, **kw)
        keys = model.programs.keys()
        model.detect_person(images[-1], **kw)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels.LAUNCH_COUNTERS}
        metrics[f"launches_replay_{precision}"] = launches
        if set(model.programs.keys()) != set(keys) or len(keys) != len(jpegs):
            raise AssertionError(f"[coco] YOLOV3 {precision}: keys {keys} then "
                                 f"{model.programs.keys()}")
        if launches["nms_sweep"] == 0:
            raise AssertionError(f"[coco] YOLOV3 {precision}: B never launched")
        # Replay vs the eager program on the same device input.
        for image in images[:len(jpegs)]:
            args = ("", image, 0.5, COCO_NMS_TH, precision, S)
            got = yd.detect_coco(*args, device=dev, forward=model._forward,
                                 programs=model.programs)
            want = yd.detect_coco(*args, device=dev, forward=model._forward)
            if not all(np.array_equal(a, b) for a, b in zip(got, want, strict=True)):
                raise AssertionError(f"[coco] YOLOV3 {precision} {image.shape}: the "
                                     "replay differs from the eager program")
        h, w = images[0].shape[:2]
        x = torch.from_numpy(yd.preprocess_coco(images[0], S, S)).to(dev)
        key = ("coco", precision, S, h, w, 0.5, float(COCO_NMS_TH))

        def run(t, model=model, h=h, w=w):
            return coco_postprocess(tuple(o[0] for o in model._forward(t)), h, w, 0.5,
                                    COCO_NMS_TH, net_h=S, net_w=S)

        def eager(run=run):
            with torch.inference_mode():
                return run(x)

        def replay(model=model, key=key, run=run):
            return model.programs.run(key, run, x)

        ms = {m: cuda_ms(fn, COCO_TIMING_REPS, warmup=2)
              for m, fn in (("eager", eager), ("replay", replay))}
        for m, v in ms.items():
            metrics[f"yolov3_ms_{precision}_{m}"] = float(np.median(v))
        busy = trace_text(metrics, f"yolov3_{precision}", eager, replay)
        print(f"[coco] YOLOV3 {precision} at {S}²: {len(images)} images ({len(keys)} "
              f"programs, keys {keys}; the second {h0}x{w0} image reused its key) in "
              f"{path_s:.2f} s, launches {launches}; each replay torch.equal to the eager "
              f"program; ms an image on a device-resident input on {card}: eager "
              f"{quartiles(ms['eager'])}, replay {quartiles(ms['replay'])}; {busy}")
        del model, x
        torch.cuda.empty_cache()
    metrics["launches_coco_replay"] = {
        k: sum(metrics[f"launches_replay_{p}"][k] for p in ("float32", "bfloat16"))
        for k in metrics["launches_replay_float32"]}
    if nms_sweep.__name__ not in metrics["launches_coco_replay"]:
        raise AssertionError("[coco] nms_sweep is not a registered kernel")
    return metrics


_DEPLOY_LOADER = r"""
import json
import sys

import numpy as np
import torch

from face_vijnana_yolov3_tpu_torch.core.export import load_artifact
from face_vijnana_yolov3_tpu_torch.ops.block_int8 import block_int8
from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import conv_int8
from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import nms_sweep

work = sys.argv[1]
cases = torch.load(work + "/cases.pt", weights_only=False)
out = {}
for name, runs in cases.items():
    art = load_artifact(f"{work}/{name}.fvyx")
    for k in (conv_int8, block_int8, nms_sweep):
        k.launches = 0
    out[name] = [tuple(t.cpu() for t in art(*args)) for args in runs]
    out[name + "_launches"] = {"conv_int8": conv_int8.launches,
                               "block_int8": block_int8.launches,
                               "nms_sweep": nms_sweep.launches}
out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax",
                        "face_vijnana_yolov3_tpu") or m.startswith(
                        "face_vijnana_yolov3_tpu_torch.api"))
torch.save(out, work + "/loaded.pt")
print(json.dumps({k: v for k, v in out.items() if k.endswith("_launches")}))
"""


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _grad_errors(got: dict, want: dict) -> tuple[float, float]:
    """(all gradients' error over their norm, the worst parameter's)."""
    total = sum(float(g.norm()) ** 2 for g in want.values()) ** 0.5
    diff = sum(float((got[k] - g).norm()) ** 2 for k, g in want.items()) ** 0.5
    worst = max(float((got[k] - g).norm() / g.norm()) for k, g in want.items()
                if float(g.norm()) > 0)
    return diff / total, worst


def deploy_phase(tmp, card, dev, rng, coco_detect8):
    """Scale-out and deploy on the card (phase 13): the distributed paths at
    world size 1 over NCCL (detect_quant_dp, one data-parallel train_detector
    step, one mesh triplet step, detect_spatial), each against its
    one-process program; the int8 (blocks on, symbolic batch) and f32
    detectors and the f32 identify program exported, loaded in a fresh
    process that imports only the loader, run at DEPLOY_BATCHES against the
    live pipelines, with that process's A0, A and B launches (the main path
    of this phase: `launches_deploy`); the export CLI at int8 on the phase-4
    JPEGs; timings of the exported programs against the eager ones and of
    the two routes to the kernels, alternated. Returns (launches, metrics)."""
    import torch.distributed as dist

    from face_vijnana_yolov3_tpu_torch import kernels
    from face_vijnana_yolov3_tpu_torch.api import export_cli
    from face_vijnana_yolov3_tpu_torch.api import face_detection as fdm
    from face_vijnana_yolov3_tpu_torch.api import face_identification as fim
    from face_vijnana_yolov3_tpu_torch.api.config import load_conf
    from face_vijnana_yolov3_tpu_torch.convert import (
        identifier_params_from_jax,
        params_from_jax,
    )
    from face_vijnana_yolov3_tpu_torch.core import export as fvy_export
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import save_checkpoint
    from face_vijnana_yolov3_tpu_torch.models import darknet
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
    from face_vijnana_yolov3_tpu_torch.models.identifier import FaceIdentifierModel
    from face_vijnana_yolov3_tpu_torch.ops.similarity import match_embeddings
    from face_vijnana_yolov3_tpu_torch.parallel import mesh as mesh_lib
    from face_vijnana_yolov3_tpu_torch.parallel.serving import detect_quant_dp
    from face_vijnana_yolov3_tpu_torch.parallel.spatial import detect_spatial
    from face_vijnana_yolov3_tpu_torch.train import trainer

    S = IMAGE_SIZE
    work = os.path.join(tmp, "deploy")
    os.makedirs(work)
    files = write_images(work, rng)
    model = FaceDetectorModel(image_size=S, device="cpu")
    params, state = model.init_params(SEED + 11)
    darknet.perturb_batchnorm(params, state, model.ops, SEED + 12)
    sd = params_from_jax(params, state)
    del model, params, state
    ckpt = os.path.join(work, "fd.pt")
    save_checkpoint(ckpt, sd, meta={"int8_tail": 0})
    conf_path = os.path.join(work, "conf.json")
    with open(conf_path, "w") as f:
        json.dump({"fd_conf": {"model_loading": True, "model_path": ckpt,
                               "int8_pallas_blocks": True,
                               "hps": {"face_conf_th": 0.05},
                               "nn_arch": {"image_size": S}},
                   "fi_conf": {"weights_path": "none.weights",
                               "nn_arch": {"image_size": S, "dense1_dim": 64}}}, f)
    calib_glob = os.path.join(work, "*.jpg")
    # The export CLI in its own process, while this one works.
    cli_out = os.path.join(work, "cli_int8.fvyx")
    cli = subprocess.Popen(
        [sys.executable, "-m", "face_vijnana_yolov3_tpu_torch.api.export_cli",
         "--conf", conf_path, "--target", "detect", "--precision", "int8",
         "--calib", calib_glob, "--out", cli_out, "--device", str(dev)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    metrics: dict = {}
    direct_route = kernels.direct_route
    try:
        conf = load_conf(conf_path)
        fdm.DEBUG = fim.DEBUG = False
        fd8 = fdm.FaceDetectorPipeline(conf.fd_conf, precision="int8")
        fd8.calibrate_int8(export_cli._load_calib(calib_glob, S))
        fd32 = fdm.FaceDetectorPipeline(conf.fd_conf, precision="float32")
        xs = {b: rng.uniform(size=(b, S, S, 3)).astype(np.float32) for b in DEPLOY_BATCHES}

        # ---- world size 1 over NCCL.
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                          RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        if not mesh_lib.init_distributed(device=dev):
            raise AssertionError("[deploy] init_distributed() did not start a group")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dist.get_backend() != backend:
            raise AssertionError(f"[deploy] backend {dist.get_backend()}, not {backend}")
        mesh = mesh_lib.make_mesh()
        x32 = xs[DEPLOY_BATCHES[-1]]
        cands, counts = fd8.detect_batch(x32)
        dp = detect_quant_dp(fd8.model, mesh, fd8._qparams, postprocess_cfg=fd8._pp_cfg,
                             fused_blocks=True)(torch.from_numpy(x32).to(dev))
        same = (np.array_equal(dp[0].cpu().numpy(), cands)
                and np.array_equal(dp[1].cpu().numpy(), counts))
        print(f"[deploy] {dist.get_backend()} world size 1, mesh {tuple(mesh.mesh.shape)} "
              f"{mesh.mesh_dim_names}: detect_quant_dp int8 b={len(x32)} (blocks on) vs "
              f"detect_batch: bit-identical {same}; counts {counts[:8].tolist()}...")
        if not same:
            raise AssertionError("[deploy] detect_quant_dp differs from detect_batch")

        # One data-parallel train_detector step at f32 b=2 vs one process.
        class _Set:
            def __init__(self, x, g):
                self.x, self.g = x, g

            def steps(self, bs):
                return 1

            def batch(self, i, bs):
                return self.x, self.g

        grid = S // 32
        tx = xs[3][:2]
        tg = rng.uniform(size=(2, grid, grid, 6)).astype(np.float32)
        model = FaceDetectorModel(image_size=S, device=dev)
        p0, s0 = darknet.split_state_dict({k: v.to(dev) for k, v in sd.items()})
        hps = {"lr": DEPLOY_TRAIN_LR, "beta_1": 0.99, "beta_2": 0.99, "decay": 0.0,
               "epochs": 1, "batch_size": 2}
        res = {}
        for name, m in (("mesh", mesh), ("one", None)):
            xb, gb, wb = (torch.from_numpy(a).to(dev) for a in trainer._pad_batch((tx, tg), 2))
            loss, grads, st = trainer.detector_loss_grads(
                model, p0, s0, xb, gb, wb, group=mesh_lib.axis_group(m, "data"))
            pp, _, losses = trainer.train_detector(model, p0, s0, _Set(tx, tg), dict(hps),
                                                   mesh=m, finalize_bn=False,
                                                   device_data=False, log_every=0)
            res[name] = (float(loss), {k: v.cpu() for k, v in grads.items()},
                         {k: v.cpu() for k, v in st.items()},
                         {k: v.cpu() for k, v in pp.items()}, losses)
        (lm, gm, sm, pm, lsm), (lo, go, so, po, lso) = res["mesh"], res["one"]
        g_rel, g_worst = _grad_errors(gm, go)
        s_err = max(float((sm[k] - v).abs().max() / v.abs().max()) for k, v in so.items())
        p_diff = torch.cat([(pm[k] - v).abs().flatten() for k, v in po.items()])
        p_max = float(p_diff.max())
        p_moved = float((p_diff > 1e-3 * DEPLOY_TRAIN_LR).float().mean())
        loss_rel = abs(lm - lo) / abs(lo)
        print(f"[deploy] data-parallel f32 step b=2 at {S}² vs one process: loss rel "
              f"{loss_rel:.2g} (tol {STEP_LOSS_RTOL}), train_detector losses {lsm} vs "
              f"{lso}; grads {g_rel:.2g} of their norm (tol {STEP_GRAD_TOL}), worst "
              f"param {g_worst:.2g} (tol {STEP_PARAM_GRAD_TOL}); BN statistics "
              f"{s_err:.2g} (tol {STEP_STATE_TOL}); params after the step max |diff| "
              f"{p_max:.3g} (tol {2 * DEPLOY_TRAIN_LR}: Adam's first step is about "
              f"lr·sign(g)), {p_moved:.3%} beyond {1e-3 * DEPLOY_TRAIN_LR:g} (the "
              f"gradients near 0, where the sign is rounding)")
        if not (loss_rel <= STEP_LOSS_RTOL and g_rel <= STEP_GRAD_TOL
                and g_worst <= STEP_PARAM_GRAD_TOL and s_err <= STEP_STATE_TOL
                and abs(lsm[0] - lso[0]) <= STEP_LOSS_RTOL * abs(lso[0])
                and p_max <= 2 * DEPLOY_TRAIN_LR):
            raise AssertionError("[deploy] the data-parallel step disagrees with one process")
        del model, p0, s0, res, gm, go, pm, po
        torch.cuda.empty_cache()

        # One triplet step on the mesh path (model_axis 1: dense1's TP
        # collectives over a one-rank group) vs one process, f32, 2 triplets.
        idm = FaceIdentifierModel(image_size=S, device=dev)
        ip, ist = idm.init_params(SEED + 13)
        darknet.perturb_batchnorm(ip, ist, idm.ops, SEED + 14)
        ip, ist = darknet.split_state_dict({k: v.to(dev) for k, v in
                                            identifier_params_from_jax(ip, ist).items()})
        # Six distinct images (a duplicate of another subject's image in the
        # semi-hard pool puts sqrt at 0), the negatives close to their
        # anchors: every triplet violates the margin, so the loss and the
        # gradients are not zero.
        anchors, positives = xs[3][:2], rng.uniform(size=(2, S, S, 3)).astype(np.float32)
        near = np.clip(anchors + rng.normal(0, 0.02, anchors.shape), 0, 1).astype(np.float32)
        feeds = [torch.from_numpy(a).to(dev) for a in (anchors, positives, near)]
        w2 = torch.ones(2, device=dev)
        sa, sn = (torch.tensor(v, device=dev) for v in ([0, 1], [1, 0]))
        tri = {}
        for name, m in (("mesh", mesh), ("one", None)):
            loss, grads, _ = trainer.triplet_loss_grads(idm, ip, ist, *feeds, w2, sa, sn,
                                                        mining="semi_hard", mesh=m)
            tri[name] = (float(loss), {k: v.cpu() for k, v in grads.items()})
        if not tri["one"][0] > 0:
            raise AssertionError("[deploy] the triplet check needs a positive loss")
        t_rel, t_worst = _grad_errors(tri["mesh"][1], tri["one"][1])
        t_loss = abs(tri["mesh"][0] - tri["one"][0])
        print(f"[deploy] mesh triplet step (semi_hard, model_axis 1) vs one process: loss "
              f"|diff| {t_loss:.2g} (tol {FI_STEP_LOSS_ATOL}), grads {t_rel:.2g} of "
              f"their norm (tol {STEP_GRAD_TOL}), worst param {t_worst:.2g}")
        if t_loss > FI_STEP_LOSS_ATOL or t_rel > STEP_GRAD_TOL:
            raise AssertionError("[deploy] the mesh triplet step disagrees with one process")
        del idm, ip, ist, tri, feeds
        torch.cuda.empty_cache()
        dp_launches, dp_metrics = mesh_programs(mesh, fd8, conf, sd, rng, card, dev)
        metrics.update(dp_metrics)
        metrics["dp_replay_launches"] = dp_launches

        # detect_spatial at world size 1 vs the f32 head.
        xd = torch.from_numpy(xs[3]).to(dev)
        folded = fd32.model.fold()
        with torch.inference_mode():
            head = fd32.model.apply_folded(folded, xd, compute_dtype=torch.float32)
        sp = detect_spatial(fd32.model, mesh, compute_dtype=torch.float32)(folded, xd)
        sp_err = float((sp - head).abs().max())
        print(f"[deploy] detect_spatial f32 b=3 vs the folded f32 head: max |diff| "
              f"{sp_err:.3g}, max |head| {float(head.abs().max()):.4g} (tol {HEAD_TOL})")
        if not sp_err <= HEAD_TOL * max(1.0, float(head.abs().max())):
            raise AssertionError("[deploy] detect_spatial disagrees with the f32 head")
        del folded, head, sp, xd
        dist.destroy_process_group()
        for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
            os.environ.pop(k)

        # ---- export, then load in a fresh process.
        fi32 = fim.FaceIdentifierPipeline(conf, precision="float32")
        reg = torch.nn.functional.normalize(torch.from_numpy(
            rng.normal(size=(10, 64)).astype(np.float32)), dim=1)
        t0 = time.perf_counter()
        fvy_export.export_detector(fd8, os.path.join(work, "int8.fvyx"))
        t_int8 = time.perf_counter() - t0
        fvy_export.export_detector(fd32, os.path.join(work, "f32.fvyx"))
        fvy_export.export_embedder(fi32, os.path.join(work, "identify.fvyx"))
        t_all = time.perf_counter() - t0
        sizes = {n: os.path.getsize(os.path.join(work, f"{n}.fvyx")) / 2**20
                 for n in ("int8", "f32", "identify")}
        cases = {"int8": [(x,) for x in xs.values()], "f32": [(x,) for x in xs.values()],
                 "identify": [(x, reg) for x in xs.values()]}
        torch.save(cases, os.path.join(work, "cases.pt"))
        loader = subprocess.run([sys.executable, "-c", _DEPLOY_LOADER, work],
                                capture_output=True, text=True, timeout=600)
        if loader.returncode != 0:
            raise AssertionError(f"[deploy] the fresh-process loader failed:\n"
                                 f"{loader.stderr[-3000:]}")
        loaded = torch.load(os.path.join(work, "loaded.pt"), weights_only=False)
        print(f"[deploy] exported int8 ({t_int8:.1f} s), f32 and identify in "
              f"{t_all:.1f} s, {', '.join(f'{k} {v:.1f} MiB' for k, v in sizes.items())}; "
              f"fresh process launches {loader.stdout.strip()}; modules of the pipelines "
              f"or jax there: {loaded['modules']}")
        if loaded["modules"]:
            raise AssertionError("[deploy] the loader imported more than it needs")
        art_launches = loaded["int8_launches"]
        if dev.type == "cuda" and min(art_launches.values()) == 0:  # (the CPU counts none)
            raise AssertionError(f"[deploy] the int8 artifact skipped a kernel: "
                                 f"{art_launches}")
        launches = {k: v + dp_launches.get(k, 0) for k, v in art_launches.items()}
        for b, x, (ac, an), (fc, fn), (emb, idx, dist_) in zip(
                DEPLOY_BATCHES, xs.values(), loaded["int8"], loaded["f32"],
                loaded["identify"]):
            c8, n8 = fd8.detect_batch(x)
            c32, n32 = fd32.detect_batch(x)
            live_emb = fi32.embed_device(x)
            live_idx, live_dist = (t.cpu() for t in match_embeddings(live_emb, reg.to(dev)))
            int8_ok = np.array_equal(ac.numpy(), c8) and np.array_equal(an.numpy(), n8)
            f32_boxes = np.array_equal(fc.numpy()[..., :4], c32[..., :4])
            f32_score = float(np.abs(fc.numpy()[..., 4:] - c32[..., 4:]).max())
            f32_ok = np.array_equal(fn.numpy(), n32) and f32_boxes and \
                f32_score <= SERVE_SCORE_TOL
            emb_err = float((emb - live_emb.cpu()).abs().max())
            id_ok = torch.equal(idx, live_idx) and \
                float((dist_ - live_dist).abs().max()) <= FI_DIST_TOL
            print(f"[deploy] artifacts in the fresh process, b={b}: int8 bit-identical "
                  f"{int8_ok}; f32 counts equal {np.array_equal(fn.numpy(), n32)}, boxes "
                  f"equal {f32_boxes}, scores max |diff| {f32_score:.3g} (tol "
                  f"{SERVE_SCORE_TOL}); identify best_idx equal {torch.equal(idx, live_idx)}, "
                  f"distances max |diff| {float((dist_ - live_dist).abs().max()):.3g} (tol "
                  f"{FI_DIST_TOL}), embeddings {emb_err:.3g}")
            if not (int8_ok and f32_ok and id_ok):
                raise AssertionError(f"[deploy] an artifact disagrees at b={b}")
        del loaded, fi32

        # ---- the CLI's int8 artifact equals the same calibration here.
        cli_log = cli.communicate(timeout=900)[0]
        if cli.returncode != 0:
            raise AssertionError(f"[deploy] export_cli failed:\n{cli_log[-3000:]}")
        art = fvy_export.load_artifact(cli_out)
        x8 = export_cli._load_calib(calib_glob, S)
        got_c, got_n = (t.cpu().numpy() for t in art(x8))
        want_c, want_n = fd8.detect_batch(x8)
        cli_ok = np.array_equal(got_c, want_c) and np.array_equal(got_n, want_n)
        print(f"[deploy] export_cli --target detect --precision int8 --calib (8 JPEGs): "
              f"{art.meta['precision']}, batch {art.meta['batch']}; on the JPEGs "
              f"bit-identical to this process's calibration {cli_ok}, counts "
              f"{got_n.tolist()}")
        if not (cli_ok and art.meta["precision"] == "int8"):
            raise AssertionError("[deploy] the CLI's artifact disagrees")
        del art

        # ---- timings on device-resident input, alternated.
        for label, b in DEPLOY_TIMING:
            fd = fd8 if label == "int8" else fd32
            art = fvy_export.load_artifact(os.path.join(work, f"{label.replace('float', 'f')}"
                                                        ".fvyx"))
            xd = [torch.from_numpy(rng.uniform(size=(b, S, S, 3)).astype(np.float32)).to(dev)
                  for _ in range(2)]
            nxt = itertools.cycle(xd).__next__
            ms = collections.defaultdict(list)
            for which in ("eager", "exported", "exported", "eager"):
                fn = (lambda: fd._detect(nxt())) if which == "eager" else (lambda: art(nxt()))
                ms[which] += cuda_ms(fn, ROUTE_REPS, warmup=2)
            for k, v in ms.items():
                metrics[f"{label}_b{b}_{k}_ms"] = float(np.median(v))
            print(f"[deploy] {label} b={b} on {card}, alternated: eager _detect "
                  f"{quartiles(ms['eager'])}; exported program {quartiles(ms['exported'])}")
            del art, xd
        x1 = xs[DEPLOY_BATCHES[-1]]
        routes = collections.defaultdict(lambda: collections.defaultdict(list))
        for op_route in (False, True, True, False):
            # The op route, as an exported program takes it: the wrappers
            # read kernels.direct_route at every call.
            kernels.direct_route = (lambda: False) if op_route else direct_route
            name = "op" if op_route else "direct"
            routes["coco_int8_b1"][name] += cuda_ms(coco_detect8, ROUTE_REPS, warmup=2)
            routes[f"detect_batch_int8_b{len(x1)}"][name] += cuda_ms(lambda: fd8.detect_batch(x1),
                                                             ROUTE_REPS, warmup=2)
        kernels.direct_route = direct_route
        for what, r in routes.items():
            for name, v in r.items():
                metrics[f"route_{what}_{name}_ms"] = float(np.median(v))
            print(f"[deploy] {what} on {card}, alternated direct/op/op/direct: direct "
                  f"{quartiles(r['direct'])}; through torch.ops.fvy "
                  f"{quartiles(r['op'])}")
    finally:
        kernels.direct_route = direct_route
        if cli.poll() is None:
            cli.kill()
            cli.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
    metrics["artifact_mib"] = sizes
    return launches, metrics



def mesh_programs(mesh, fd8, conf, sd, rng, card, dev) -> tuple[dict, dict]:
    """The mesh paths' programs at world size 1 over NCCL (phase 13; the
    collectives captured into the graphs): the DP int8 detect at
    DEPLOY_DP_B with the blocks on, the launch counts zeroed just before
    and read just after (A0, A and B must move), its replays and a DP ROI
    identify chunk's (f32, DEPLOY_ROI_BOXES crops on two frames) against
    their eager programs (torch.equal); the detector step at f32 and
    fake-quant and the semi-hard triplet step with the mesh, eager vs replay
    over DEPLOY_MESH_STEPS steps under deterministic algorithms (every carry
    tensor and loss torch.equal, one captured graph each); ms a call and a
    step eager vs replay with the busy shares. Returns (launches, metrics)."""
    from face_vijnana_yolov3_tpu_torch import kernels
    from face_vijnana_yolov3_tpu_torch.api import face_identification as fim
    from face_vijnana_yolov3_tpu_torch.convert import identifier_params_from_jax
    from face_vijnana_yolov3_tpu_torch.core.programs import ProgramCache
    from face_vijnana_yolov3_tpu_torch.models import darknet
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
    from face_vijnana_yolov3_tpu_torch.models.identifier import FaceIdentifierModel
    from face_vijnana_yolov3_tpu_torch.ops import roi
    from face_vijnana_yolov3_tpu_torch.parallel import mesh as mesh_lib
    from face_vijnana_yolov3_tpu_torch.parallel.serving import detect_quant_dp, identify_roi_dp
    from face_vijnana_yolov3_tpu_torch.train import optimizer, trainer

    S = IMAGE_SIZE
    metrics: dict = {}
    x = torch.from_numpy(rng.uniform(size=(DEPLOY_DP_B, S, S, 3)).astype(np.float32)).to(dev)
    dp = detect_quant_dp(fd8.model, mesh, fd8._qparams, postprocess_cfg=fd8._pp_cfg,
                         fused_blocks=True)
    for k in kernels.LAUNCH_COUNTERS:
        k.launches = 0
    outs = [dp(x) for _ in range(3)]
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels.LAUNCH_COUNTERS}
    with torch.inference_mode():
        want = dp.program(x)
    same = all(torch.equal(a, b) for o in outs for a, b in zip(o, want, strict=True))
    print(f"[deploy] DP int8 detect b={DEPLOY_DP_B} (blocks on), mesh key "
          f"{dp.programs.keys()}: 3 calls, launches {launches}; replay torch.equal to the "
          f"eager program {same}")
    if not same:
        raise AssertionError("[deploy] the DP detect replay differs from its eager program")
    if min(launches[k] for k in ("conv_int8", "block_int8", "nms_sweep")) == 0:
        raise AssertionError(f"[deploy] the DP detect replay skipped a kernel: {launches}")
    ms = {"eager": cuda_ms(lambda: dp.program(x), ROUTE_REPS, warmup=2),
          "replay": cuda_ms(lambda: dp(x), ROUTE_REPS, warmup=2)}
    for m, v in ms.items():
        metrics[f"dp_detect_b{DEPLOY_DP_B}_{m}_ms"] = float(np.median(v))
    busy = trace_text(metrics, f"dp_detect_b{DEPLOY_DP_B}", lambda: dp.program(x),
                      lambda: dp(x))
    print(f"[deploy] DP int8 detect b={DEPLOY_DP_B} on {card}: eager "
          f"{quartiles(ms['eager'])}, replay {quartiles(ms['replay'])}; {busy}")
    del dp, outs, want, x

    # A DP ROI identify chunk: the windows of DEPLOY_ROI_BOXES faces on two
    # 480x640 frames, one bucket.
    fi = fim.FaceIdentifierPipeline(conf, precision="float32")
    bh, bw = 480, 640
    staged = torch.from_numpy(rng.integers(0, 256, (2, bh, bw, 3)).astype(np.uint8)).to(dev)
    wins = [(int(rng.integers(0, 300)), int(rng.integers(0, 450)),
             int(rng.integers(40, 170)), int(rng.integers(40, 170)))
            for _ in range(DEPLOY_ROI_BOXES)]
    wh = roi.window_bucket(max(w[2] for w in wins), bh)
    ww = roi.window_bucket(max(w[3] for w in wins), bw)
    origins = np.array([(k % 2, min(y0, bh - wh), min(x0, bw - ww))
                        for k, (y0, x0, _, _) in enumerate(wins)], np.int32)
    packed = torch.from_numpy(roi.pack_roi_operands(
        origins, *roi.stack_roi_taps(wins, S, origins[:, 1:]))[None]).to(dev)
    reg = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(10, fi.model.dense1_dim)).astype(np.float32)), dim=1).to(dev)
    ident = identify_roi_dp(fi._embed_program, mesh, image_size=S, window_h=wh, window_w=ww)
    rows = [ident(staged, packed, reg) for _ in range(2)]
    with torch.inference_mode():
        want = ident.program(staged, packed, reg)
    same = all(torch.equal(r, want) for r in rows)
    ms = {"eager": cuda_ms(lambda: ident.program(staged, packed, reg), ROUTE_REPS, warmup=2),
          "replay": cuda_ms(lambda: ident(staged, packed, reg), ROUTE_REPS, warmup=2)}
    for m, v in ms.items():
        metrics[f"dp_roi_{m}_ms"] = float(np.median(v))
    busy = trace_text(metrics, "dp_roi", lambda: ident.program(staged, packed, reg),
                      lambda: ident(staged, packed, reg))
    print(f"[deploy] DP ROI identify chunk, {DEPLOY_ROI_BOXES} crops (window {wh}x{ww}) "
          f"f32: replay torch.equal to the eager program {same}; on {card}: eager "
          f"{quartiles(ms['eager'])}, replay {quartiles(ms['replay'])}; {busy}")
    if not same:
        raise AssertionError("[deploy] the DP ROI replay differs from its eager program")
    del ident, fi, staged, rows, want
    torch.cuda.empty_cache()

    # The mesh training steps, eager vs replay.
    grid, b = S // 32, DEPLOY_MESH_B
    model = FaceDetectorModel(image_size=S, device=dev)
    p0, s0 = darknet.split_state_dict({k: v.to(dev) for k, v in sd.items()})
    group = mesh_lib.axis_group(mesh, "data")
    feeds = [(torch.from_numpy(rng.uniform(size=(b, S, S, 3)).astype(np.float32)).to(dev),
              torch.from_numpy(rng.uniform(size=(b, grid, grid, 6)).astype(np.float32))
              .to(dev), torch.ones(b, device=dev)) for _ in range(DEPLOY_MESH_STEPS)]
    idm = FaceIdentifierModel(image_size=S, device=dev)
    ip, ist = idm.init_params(SEED + 15)
    darknet.perturb_batchnorm(ip, ist, idm.ops, SEED + 16)
    ip, ist = darknet.split_state_dict({k: v.to(dev) for k, v in
                                        identifier_params_from_jax(ip, ist).items()})
    tb = DEPLOY_MESH_TRIPLET_B
    sa = torch.arange(tb, dtype=torch.int32, device=dev)
    tfeeds = [(*(torch.from_numpy(rng.uniform(size=(tb, S, S, 3)).astype(np.float32))
                 .to(dev) for _ in range(3)), torch.ones(tb, device=dev), sa, (sa + 1) % tb)
              for _ in range(DEPLOY_MESH_STEPS)]
    opt = optimizer.KerasAdam(DEPLOY_TRAIN_LR)
    cases = [(f"detector {label} b={b}", ("detector", "torch.float32", fq),
              trainer.make_train_step(model, opt, fakequant=fq, group=group), (p0, s0), feeds)
             for label, fq in (("f32", False), ("fake-quant", True))]
    cases.append((f"semi-hard triplet b={tb}",
                  ("identifier", "torch.float32", "semi_hard", False, False),
                  trainer.make_triplet_step(idm, opt, mining="semi_hard", mesh=mesh),
                  (ip, ist), tfeeds))
    for name, key, step, (params, state), case_feeds in cases:
        carry0 = (params, state, opt.init(params))
        programs = ProgramCache(dev, train=True)
        replay = trainer.program_step(programs, key + mesh_lib.mesh_key(mesh), step, 3)
        with trainer.deterministic():
            want, w_losses = _run_steps(step, carry0, case_feeds)
            got, g_losses = _run_steps(replay, carry0, case_feeds)
            torch.cuda.synchronize()
            # Before the timing: its replays overwrite the program's carry.
            diff, total = _carry_diff(got, want)
            same_loss = all(torch.equal(a, c) for a, c in zip(g_losses, w_losses))
            ms = {"eager": _step_ms(step, carry0, case_feeds),
                  "replay": _step_ms(replay, carry0, case_feeds)}
        tag = name.split(" b=")[0].replace(" ", "_")
        for m, v in ms.items():
            metrics[f"mesh_{tag}_{m}_ms"] = float(np.median(v))
        print(f"[deploy] mesh {name} at {S}², {DEPLOY_MESH_STEPS} steps, eager vs replay "
              f"(key {programs.keys()[0][:-3]}...): {diff} of {total} param/BN/Adam "
              f"tensors differ, losses equal {same_loss}; one captured graph "
              f"{_one_graph(programs)}; ms a step on {card}: eager "
              f"{quartiles(ms['eager'])}, replay {quartiles(ms['replay'])}")
        if diff or not same_loss or not _one_graph(programs):
            raise AssertionError(f"[deploy] mesh {name}: replay != eager")
        del programs, replay, want, got
        torch.cuda.empty_cache()
    del model, idm, feeds, tfeeds, p0, s0, ip, ist
    torch.cuda.empty_cache()
    return launches, metrics


def _epoch_means(losses: list[float], epochs: int) -> tuple[float, float]:
    """Mean loss of the first and of the last epoch of a run's step losses."""
    steps = len(losses) // epochs
    return float(np.mean(losses[:steps])), float(np.mean(losses[-steps:]))


def release_phase(tmp, card, dev):
    """The release loop through its tools (scripts/), at 416² on reduced
    data (RELEASE_*): train_qat_recipe plain then --init-from fake-quant
    (epochs reached, the sidecar's qat flag, the loss falling in each
    phase), select_serving_tail over RELEASE_TAILS (the pin written equals
    the tail returned; A0 and B launch in its AP passes), release_ap (f32,
    bf16 with the probed guard, int8 at the pin, which a fresh int8 pipeline
    must report), the pinned int8 served with the fused blocks on and off
    (equal CSVs, A launches), int8_error_profile at the pin (one finite,
    non-negative row per int8 conv), and synthetic_fi_e2e (the triplet loss
    falling). Returns (the launches over the phase, its numbers)."""
    from face_vijnana_yolov3_tpu_torch.api.config import FdConf
    from face_vijnana_yolov3_tpu_torch.api.face_detection import FaceDetectorPipeline
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import load_train_meta
    from face_vijnana_yolov3_tpu_torch.data.synthetic import make_dataset
    from face_vijnana_yolov3_tpu_torch.models import quant
    from face_vijnana_yolov3_tpu_torch.ops.block_int8 import block_int8
    from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import conv_int8
    from face_vijnana_yolov3_tpu_torch.ops.front_fused import fused_front
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_host
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import nms_sweep
    from face_vijnana_yolov3_tpu_torch.scripts import (
        release_ap,
        select_serving_tail,
        synthetic_fi_e2e,
        train_qat_recipe,
    )
    from face_vijnana_yolov3_tpu_torch.scripts.synthetic_e2e import make_valset

    kernels = {"nms_sweep": nms_sweep, "conv_int8": conv_int8, "block_int8": block_int8,
               "fused_front": fused_front}

    def counts():
        torch.cuda.synchronize()
        return {k: f.launches for k, f in kernels.items()}

    work = os.path.join(tmp, "release")
    t0 = time.perf_counter()
    make_dataset(work, n_train=RELEASE_TRAIN, n_val=RELEASE_VAL, seed=SEED)
    valdir = make_valset(work)
    data_s = time.perf_counter() - t0
    rec = {"data_s": data_s}
    for f in kernels.values():
        f.launches = 0

    # Recipe v3 at reduced scale: plain, then the fake-quant finetune.
    t0 = time.perf_counter()
    meta_p, losses_p = train_qat_recipe.main([work, str(RELEASE_PLAIN), "--plain"])
    t_plain = time.perf_counter() - t0
    t0 = time.perf_counter()
    meta_q, losses_q = train_qat_recipe.main(
        [work, str(RELEASE_FT), "--init-from", "fd_ckpt_plain", "--lr", "1e-4"])
    t_ft = time.perf_counter() - t0
    ckpt = os.path.join(work, "fd_ckpt_qat.pt")
    falls = {"plain": _epoch_means(losses_p, RELEASE_PLAIN),
             "fakequant": _epoch_means(losses_q, RELEASE_FT)}
    side = load_train_meta(ckpt)
    print(f"[release] recipe v3 at {IMAGE_SIZE}², {RELEASE_TRAIN} train / {RELEASE_VAL} "
          f"val images, batch 16, on {card}: {RELEASE_PLAIN} plain epochs at 1e-3 "
          f"({t_plain:.1f} s, meta {meta_p}), then {RELEASE_FT} fake-quant epochs at "
          f"1e-4 --init-from fd_ckpt_plain ({t_ft:.1f} s, meta {meta_q}); first -> last "
          f"epoch mean loss: plain {falls['plain'][0]:.5f} -> {falls['plain'][1]:.5f}, "
          f"fake-quant {falls['fakequant'][0]:.5f} -> {falls['fakequant'][1]:.5f}; "
          f"sidecar {side}; dataset {data_s:.1f} s")
    if meta_p["epochs_done"] != RELEASE_PLAIN or meta_q["epochs_done"] != RELEASE_FT:
        raise AssertionError("[release] the recipe's meta missed its epochs")
    if side.get("qat") is not True or meta_q.get("recipe_ver") != 3:
        raise AssertionError("[release] the finetuned checkpoint is not marked QAT "
                             "recipe v3")
    if any(last >= first for first, last in falls.values()):
        raise AssertionError(f"[release] a recipe phase's loss did not fall: {falls}")
    rec.update(plain_s=t_plain, ft_s=t_ft, sec_per_epoch_plain=meta_p["sec_per_epoch"],
               sec_per_epoch_ft=meta_q["sec_per_epoch"], loss=falls)

    # Select and pin the int8 tail on the finished artifact.
    before = counts()
    t0 = time.perf_counter()
    tail, table = select_serving_tail.main(
        [work, "fd_ckpt_qat", "--tails", ",".join(map(str, RELEASE_TAILS))])
    select_s = time.perf_counter() - t0
    moved = {k: v - before[k] for k, v in counts().items()}
    pin = load_train_meta(ckpt).get("int8_tail")
    print(f"[release] select_serving_tail over tails {RELEASE_TAILS} on {card}: "
          f"table {table}, pinned {pin} ({select_s:.1f} s); launches in its AP passes "
          f"{moved}")
    if pin != tail:
        raise AssertionError(f"[release] pinned {pin}, selected {tail}")
    if moved["conv_int8"] == 0 or moved["nms_sweep"] == 0:
        raise AssertionError(f"[release] the AP passes skipped a kernel: {moved}")
    rec.update(tail=tail, table=table, select_s=select_s)

    # Held-out APs as served: f32, bf16 (probed guard), int8 (the pin).
    aps = release_ap.main([work, "fd_ckpt_qat", "--resamples", str(RELEASE_RESAMPLES)])
    if aps["int8"]["int8_tail"] != pin:
        raise AssertionError(f"[release] a fresh int8 pipeline served tail "
                             f"{aps['int8']['int8_tail']}, the pin is {pin}")
    rec["aps"] = aps

    # The pinned int8 configuration with the fused blocks on and off.
    csvs, pipes = {}, {}
    for blocks in (True, False):
        conf = FdConf(test_path=valdir, model_loading=True, model_path=ckpt,
                      output_file_path=os.path.join(work, f"pinned_blocks_{blocks}.csv"),
                      int8_pallas_blocks=blocks)
        conf.nn_arch.image_size = IMAGE_SIZE
        a0 = counts()
        pipes[blocks] = FaceDetectorPipeline(conf, precision="int8")
        pipes[blocks].test()
        moved = {k: v - a0[k] for k, v in counts().items()}
        csvs[blocks] = open(conf.output_file_path).read()
        print(f"[release] pinned int8 (tail {pipes[blocks].int8_tail_chosen}) test mode "
              f"on the {RELEASE_VAL} val images, fused blocks {'on' if blocks else 'off'}: "
              f"{csvs[blocks].count(chr(10))} rows at face_conf_th "
              f"{conf.hps.face_conf_th}; launches {moved}")
        if blocks and moved["block_int8"] == 0:
            raise AssertionError("[release] the blocks-on run never launched block_int8")
    if csvs[True] != csvs[False]:
        raise AssertionError("[release] the pinned int8 CSVs differ with the blocks on "
                             "and off")

    # int8_error_profile of the trained checkpoint at the pin.
    fd = pipes[False]
    files = sorted(f for f in os.listdir(valdir) if f.endswith(".jpg"))
    x = torch.from_numpy(np.asarray(
        [letterbox_host(imread(os.path.join(valdir, f)) / 255, IMAGE_SIZE, "cubic")[0]
         for f in files[:RELEASE_PROFILE_IMAGES]], np.float32)).to(dev)
    t0 = time.perf_counter()
    prof = quant.int8_error_profile(fd._qparams, fd.model.fold(), x, fd.model.ops)
    profile_s = time.perf_counter() - t0
    n_ops = fd._qparams.get("tail_start")
    n_ops = len(fd.model.ops) if n_ops is None else n_ops
    want = [op[1] for op in fd.model.ops[:n_ops] if op[0] == "conv"]
    worst = sorted(prof.items(), key=lambda kv: -kv[1])[:3]
    print(f"[release] int8_error_profile at tail {pin} on {len(x)} val images "
          f"({profile_s:.1f} s on {card}): {len(prof)} rows for {len(want)} int8 convs; "
          f"worst three {[(k, round(v, 5)) for k, v in worst]}; conv_0 "
          f"{prof.get(want[0], float('nan')):.5f}")
    if list(prof) != want or not all(np.isfinite(v) and v >= 0 for v in prof.values()):
        raise AssertionError("[release] int8_error_profile: not one finite, non-negative "
                             "row per int8 conv")
    rec.update(profile_worst=worst, profile_s=profile_s)
    del pipes, fd, x
    torch.cuda.empty_cache()

    # The FI loop at full width.
    t0 = time.perf_counter()
    fi = synthetic_fi_e2e.main([os.path.join(tmp, "release_fi"), str(RELEASE_FI_EPOCHS),
                                str(RELEASE_FI_SUBJECTS)])
    fi_s = time.perf_counter() - t0
    first, last = _epoch_means(fi["losses"], RELEASE_FI_EPOCHS)
    ths, vals, fars = fi["val_far"]
    k = int(np.argmin(np.abs(np.asarray(ths) - 0.5)))
    print(f"[release] synthetic_fi_e2e, {RELEASE_FI_SUBJECTS} subjects, "
          f"{RELEASE_FI_EPOCHS} bf16 epochs at {IMAGE_SIZE}² on {card} ({fi_s:.1f} s): "
          f"triplet loss first -> last epoch mean {first:.5f} -> {last:.5f}; held-out "
          f"top-1 untrained {fi['top1_untrained']:.3f}, trained {fi['top1']:.3f}; "
          f"VAL {vals[k]:.3f} FAR {fars[k]:.3f} at sim_th {ths[k]:.1f} (not gated)")
    if last >= first:
        raise AssertionError("[release] the triplet loss did not fall")
    rec.update(fi_s=fi_s, fi_loss=(first, last), top1=(fi["top1_untrained"], fi["top1"]),
               val_far_05=(float(vals[k]), float(fars[k])))
    launches = counts()
    if min(launches[k] for k in ("nms_sweep", "conv_int8", "block_int8")) == 0:
        raise AssertionError(f"[release] the phase skipped a kernel: {launches}")
    return launches, rec


def programs_phase(tmp, card, dev, rng):
    """The captured serving programs on the card (phase 15, PROGRAM_*):
    for each of PROGRAM_RUNS, `detect_batch` (f32 batch from host memory)
    and `detect_batch_fused` (staged uint8 frames of two sizes, a full
    chunk and a short last chunk of PROGRAM_SHORT frames padded to the
    batch, which must reuse the full chunk's program) against the eager
    `_detect_program` on the same (padded) inputs: int8 torch.equal, f32
    and bf16 within their rules; then an f32 device-ROI identify chunk
    (the PROGRAM_ROI_BOXES crops, 17: the programs of 16 and 1) against
    the eager program functions (equal rows); then a
    function that syncs with the host (`.item()`) must raise ProgramError
    at capture, and the card must serve after it. The launch counts are
    zeroed after the captures and read after the replays, which
    torch.profiler traces: the kernels the trace shows by name must equal
    the counts, and A0, A and B must have launched inside replayed
    programs. Each case prints eager vs replay ms a call (CUDA events
    around the serving call, from host memory, host work included) and
    the device busy share of each (`device_trace`). Returns (the launches
    under replay, the numbers)."""
    from face_vijnana_yolov3_tpu_torch.api import face_identification as fim
    from face_vijnana_yolov3_tpu_torch.api.config import Conf, FdConf
    from face_vijnana_yolov3_tpu_torch.api.face_detection import FaceDetectorPipeline
    from face_vijnana_yolov3_tpu_torch.convert import (
        identifier_params_from_jax,
        params_from_jax,
    )
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import save_checkpoint
    from face_vijnana_yolov3_tpu_torch.core.programs import ProgramCache, ProgramError
    from face_vijnana_yolov3_tpu_torch.models import darknet
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
    from face_vijnana_yolov3_tpu_torch import kernels
    from face_vijnana_yolov3_tpu_torch.models.identifier import FaceIdentifierModel
    from face_vijnana_yolov3_tpu_torch.ops import (  # noqa: F401  (register the wrappers)
        block_int8,
        conv_int8,
        front_fused,
        nms_sweep,
    )
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_geometry, letterbox_host
    from torch.profiler import ProfilerActivity, profile

    S = IMAGE_SIZE
    kernel_fns = kernels.LAUNCH_COUNTERS
    replay_launches = collections.Counter()
    rates = {}
    model = FaceDetectorModel(image_size=S, device="cpu")
    params, state = model.init_params(SEED)
    darknet.perturb_batchnorm(params, state, model.ops, SEED + 1)
    ckpt = os.path.join(tmp, "fd_programs.pt")
    save_checkpoint(ckpt, params_from_jax(params, state))
    del model, params, state
    b_max = max(r[2] for r in PROGRAM_RUNS)
    frames = [rng.integers(0, 256, PROGRAM_FRAMES[k % 2] + (3,), dtype=np.uint8)
              for k in range(b_max)]
    staged_all = np.zeros((b_max,) + PROGRAM_FRAMES[0] + (3,), np.uint8)
    for k, im in enumerate(frames):
        staged_all[k, : im.shape[0], : im.shape[1]] = im
    geoms_all = [letterbox_geometry(*im.shape[:2], S) for im in frames]

    def diff(label, got, want):
        """Check replayed (cands, counts) against the eager ones."""
        (gc, gn), (wc, wn) = got, want
        err = float(np.abs(gc - wc).max())
        same = np.array_equal(gc, wc) and np.array_equal(gn, wn)
        if label == "int8":
            ok = same
        elif not np.array_equal(gn, wn):
            ok = False
        elif label == "f32":
            box_exact = float(np.mean(gc[..., :4] == wc[..., :4]))
            ok = box_exact >= SERVE_BOX_EXACT and float(
                np.abs(gc[..., 5] - wc[..., 5]).max()) <= SERVE_SCORE_TOL
        else:
            ok = (float(np.abs(gc[..., :4] - wc[..., :4]).max()) <= PROGRAM_BF16_BOX_TOL
                  and float(np.abs(gc[..., 5] - wc[..., 5]).max()) <= PROGRAM_BF16_SCORE_TOL)
        return same, err, ok

    def host(out):
        return tuple(t.cpu().numpy() for t in out)

    int8_check = None
    for label, precision, b, depth in PROGRAM_RUNS:
        conf = FdConf(model_loading=True, model_path=ckpt, int8_pallas_blocks=True,
                      int8_tail_auto=False, bf16_f32_front=depth or 2)
        conf.nn_arch.image_size = S
        conf.hps.face_conf_th = 0.05
        fd = FaceDetectorPipeline(conf, precision=precision, device=dev)
        x = rng.uniform(size=(b, S, S, 3)).astype(np.float32)
        if precision == "int8":
            fd.calibrate_int8(x)  # eager, before the first capture
        staged, geoms = staged_all[:b], geoms_all[:b]
        short, short_geoms = staged_all[:PROGRAM_SHORT], geoms_all[:PROGRAM_SHORT]
        # The captures.
        fd.detect_batch(x)
        fd.detect_batch_fused(staged, geoms, pad_batch_to=b)
        fd.detect_batch_fused(short, short_geoms, pad_batch_to=b)
        keys = fd.programs.keys()
        # The replays, with the counts zeroed just before and read after,
        # and the kernels their trace shows.
        for k in kernel_fns:
            k.launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = fd.detect_batch(x)
            got_f = fd.detect_batch_fused(staged, geoms, pad_batch_to=b)
            got_s = fd.detect_batch_fused(short, short_geoms, pad_batch_to=b)
            torch.cuda.synchronize()
        launched = {k.__name__: k.launches for k in kernel_fns}
        traced = traced_launches(prof)
        replay_launches.update(launched)
        if len(keys) != 2 or len(fd.programs) != 2:
            raise AssertionError(f"[programs] {label}: expected one detect and one fused "
                                 f"program (the short chunk reusing it), got {keys}")
        # The eager functions on the same (padded) device inputs.
        with torch.inference_mode():
            x_dev = torch.from_numpy(x).to(dev)
            want = host(fd._detect_program(x_dev))
            ins_f = fd._fused_inputs(staged, geoms, b, None)[:3]
            ins_s = fd._fused_inputs(short, short_geoms, b, None)[:3]
            want_f = host(fd._fused_program(*ins_f))
            want_s = tuple(a[:PROGRAM_SHORT] for a in host(fd._fused_program(*ins_s)))
        checks = {name: diff(label, g, w) for name, g, w in (
            ("detect_batch", got, want), ("fused", got_f, want_f),
            ("fused short chunk", got_s, want_s))}
        if label == "int8":
            int8_check = (fd, x, got)
        # Times of the serving call from host memory, eager vs replay.
        key_f = fd._fused_key(ins_f[0], False)

        def eager_detect():
            with torch.inference_mode():
                return host(fd._detect_program(torch.as_tensor(x, device=dev)))

        def eager_fused():
            with torch.inference_mode():
                ins = fd._fused_inputs(staged, geoms, b, None)[:3]
                return host(fd._fused_program(*ins))

        calls = {
            "detect_batch": (eager_detect, lambda: fd.detect_batch(x)),
            "detect_batch_fused": (eager_fused,
                                   lambda: fd.detect_batch_fused(staged, geoms, pad_batch_to=b)),
        }
        timing = []
        for name, (eager_fn, replay_fn) in calls.items():
            ms = {m: cuda_ms(fn, PROGRAM_REPS, warmup=2)
                  for m, fn in (("eager", eager_fn), ("replay", replay_fn))}
            for m in ("eager", "replay"):
                rates[f"{label}_b{b}_{name}_{m}_ms"] = float(np.median(ms[m]))
            timing.append(f"{name}: eager {quartiles(ms['eager'])}; replay "
                          f"{quartiles(ms['replay'])}; " + trace_text(
                              rates, f"{label}_b{b}_{name}", eager_fn, replay_fn))
        with torch.inference_mode():
            prog_ms = {m: float(np.median(cuda_ms(fn, PROGRAM_REPS, warmup=2))) for m, fn in (
                ("eager", lambda: fd._fused_program(*ins_f)),
                ("replay", lambda: fd.programs.run(key_f, fd._fused_program, *ins_f)))}
        rates[f"{label}_b{b}_fused_device_inputs_ms"] = prog_ms
        print(f"[programs] {label} b={b} on {card}: programs {keys}; replayed vs eager "
              + "; ".join(f"{n} torch.equal {c[0]}, max |diff| {c[1]:.3g}"
                          for n, c in checks.items())
              + f"; launches under replay {launched}, in the replays' trace {traced}")
        print(f"[programs] {label} b={b} on {card}, a call from host memory: "
              + " | ".join(timing) + f" | fused program on device inputs: eager "
              f"{prog_ms['eager']:.3f} ms, replay {prog_ms['replay']:.3f} ms")
        if not all(c[2] for c in checks.values()):
            raise AssertionError(f"[programs] {label}: a replayed program disagrees with the "
                                 f"eager one: {checks}")
        if traced != launched:
            raise AssertionError(f"[programs] {label}: the replays' trace shows {traced} "
                                 f"kernel launches, the counters {launched}")
        if traced["nms_sweep"] < 3 or (label == "int8" and min(
                traced["conv_int8"], traced["block_int8"]) == 0):
            raise AssertionError(f"[programs] {label}: a kernel did not launch under "
                                 f"replay: {traced}")
        if label != "int8":
            del fd
        torch.cuda.empty_cache()

    # The identify chunk: f32 device-ROI, one program.
    fi_model = FaceIdentifierModel(image_size=S, device="cpu")
    params, state = fi_model.init_params(SEED + 7)
    darknet.perturb_batchnorm(params, state, fi_model.ops, SEED + 8)
    fi_ckpt = os.path.join(tmp, "fi_programs.pt")
    save_checkpoint(fi_ckpt, identifier_params_from_jax(params, state))
    del fi_model, params, state
    conf = Conf()
    conf.fi_conf.model_loading, conf.fi_conf.model_path = True, fi_ckpt
    conf.fi_conf.nn_arch.image_size = S
    conf.fi_conf.hps.sim_th = 1e9  # every crop matches: the rows show every argmin
    conf.fd_conf.model_loading, conf.fd_conf.model_path = True, ckpt
    conf.fd_conf.nn_arch.image_size = S
    fi = fim.FaceIdentifierPipeline(conf, device=dev)
    images = frames[:len(PROGRAM_ROI_BOXES)]
    boxes_list = []
    for im, nb in zip(images, PROGRAM_ROI_BOXES):
        h, w = im.shape[:2]
        x0, y0 = rng.uniform(0, w * 0.6, nb), rng.uniform(0, h * 0.6, nb)
        boxes_list.append(np.stack([x0, y0, x0 + rng.uniform(40, 200, nb),
                                    y0 + rng.uniform(40, 200, nb),
                                    rng.uniform(0.05, 1, nb)], axis=1))
    reg = fi.embed(np.asarray([letterbox_host(im[:160, :160] / 255, S, "cubic")[0]
                               for im in frames[:8]], np.float32))
    ids = [f"s{k}" for k in range(len(reg))]
    reg_dev = torch.from_numpy(reg).to(dev)
    fi._identify_chunk_device(images, boxes_list, ids, reg_dev)  # the captures
    owners, plan = fi._roi_plan(images, boxes_list)
    progs = fi._roi_inputs(plan, reg_dev)
    with torch.inference_mode():  # the eager program functions
        e_idx, e_dist = (torch.cat(t) for t in zip(*(fn(*ins) for _k, fn, *ins in progs)))
    for k in kernel_fns:
        k.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rows = fi._identify_chunk_device(images, boxes_list, ids, reg_dev)
        torch.cuda.synchronize()
    launched = {k.__name__: k.launches for k in kernel_fns}
    traced = traced_launches(prof)
    replay_launches.update(launched)
    with torch.inference_mode():
        r_idx, r_dist = (torch.cat(t) for t in zip(*(fi.programs.run(*p) for p in progs)))
    torch.cuda.synchronize()
    n = len(owners)
    eager_rows = [[] for _ in images]
    for r, (j, k) in enumerate(owners):
        eager_rows[j].append((k, ids[int(e_idx[r])]))
    got_rows = [[(row["box_index"], row["subject_id"]) for row in rr] for rr in rows]
    same = torch.equal(e_idx, r_idx) and torch.equal(e_dist, r_dist)

    def eager_chunk():
        _o, pl = fi._roi_plan(images, boxes_list)
        with torch.inference_mode():
            return [torch.cat(t).cpu() for t in zip(*(
                f(*i) for _k, f, *i in fi._roi_inputs(pl, reg_dev)))]

    def replay_chunk():
        return fi._identify_chunk_device(images, boxes_list, ids, reg_dev)

    ms = {m: cuda_ms(f, PROGRAM_REPS, warmup=2)
          for m, f in (("eager", eager_chunk), ("replay", replay_chunk))}
    for m in ("eager", "replay"):
        rates[f"identify_chunk_{m}_ms"] = float(np.median(ms[m]))
    print(f"[programs] f32 device-ROI identify chunk ({len(images)} frames, {n} crops, "
          f"programs {[p[0][:2] for p in progs]}) on {card}: rows equal to the eager "
          f"programs' {got_rows == eager_rows}, (idx, dist) torch.equal {same}; launches "
          f"under replay {launched}, in the trace {traced}; eager {quartiles(ms['eager'])}; "
          f"replay {quartiles(ms['replay'])}; "
          + trace_text(rates, "identify_chunk", eager_chunk, replay_chunk))
    if (got_rows != eager_rows or n != sum(PROGRAM_ROI_BOXES) or not same
            or [p[0][1] for p in progs] != [16, 1]):
        raise AssertionError("[programs] the replayed identify chunk disagrees with the "
                             "eager one")
    if traced != launched:
        raise AssertionError(f"[programs] identify: the trace shows {traced}, the "
                             f"counters {launched}")
    del fi
    torch.cuda.empty_cache()

    # A host sync inside a program must raise at capture, never serve eagerly.
    cache = ProgramCache(dev)
    t = torch.arange(8.0, device=dev)
    try:
        cache.run(("host_sync", 8), lambda v: v * float(v.sum().item()), t)
    except ProgramError as e:
        err = str(e).splitlines()[0][:160]
    else:
        raise AssertionError("[programs] a capture with .item() did not raise")
    fd, x, got = int8_check
    again = fd.detect_batch(x)
    print(f"[programs] capture of a function calling .item(): ProgramError ({err}); "
          f"{len(cache)} programs kept; the int8 program replays after it, equal "
          f"{all(np.array_equal(a, g) for a, g in zip(again, got))}")
    if len(cache) or not all(np.array_equal(a, g) for a, g in zip(again, got)):
        raise AssertionError("[programs] the card does not serve as before after a "
                             "failed capture")
    del fd, int8_check
    torch.cuda.empty_cache()
    return dict(replay_launches), rates


def programs_phase_fresh(tmp: str) -> tuple[dict, dict]:
    """Phase 15 in a fresh process, its lines passed through: late in this
    long process torch.profiler drops device events (a whole smoke's trace
    of the int8 replays named 25 of 36 A0 and 51 of 60 A launches; a fresh
    process names all), and the phase holds the counters to that trace.
    Returns the phase's (launches under replay, numbers)."""
    out = os.path.join(tmp, "programs_phase.json")
    code = ("import json, numpy as np, torch, chip_smoke as cs; "
            "from face_vijnana_yolov3_tpu_torch import kernels; kernels.build(); "
            f"r = cs.programs_phase({tmp!r}, cs.nvidia_smi(), torch.device(cs.DEVICE), "
            f"np.random.default_rng(cs.SEED + 15)); json.dump(r, open({out!r}, 'w'))")
    sys.stdout.flush()
    proc = subprocess.run([sys.executable, "-c", code], timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"[programs] the fresh process failed (exit {proc.returncode})")
    with open(out) as f:
        launches, rates = json.load(f)
    return launches, rates


def modes_phase(tmp, card, dev, rng):
    """The two serving modes taken over last (phase 16, MODES_*), on phase
    14's checkpoint (tmp/release/fd_ckpt_qat.pt) and val set.

    The main path, its launch counts zeroed before and read after: (a)
    FaceDetectorPipeline(precision="int8", int8_qat_steps, blocks on)
    calibrates on MODES_CALIB letterboxed training images (distillation QAT,
    then int8 at the frozen scales) and serves the val JPEGs in test mode;
    a PTQ int8 pipeline (the sidecar's pinned tail) serves them too; (b)
    precision="bfloat16" with bf16_front_mode="int8" at each of
    MODES_DEPTHS, and the f32-guard bf16 at depth 2, serve them; (c) the FI
    bf16 embed with fi_conf.bf16_front_mode="int8" of MODES_FI_CROPS crops.
    Then the checks: the QAT int8 trunk card == CPU (torch.equal), the
    fake-quant head vs the served head (INT8_HEAD_TOL), each fake-quant conv
    exact wherever its sums stay below 2^24 and the fake-quant trunk equal
    to the served one when none passes it, head MSE against the f32 teacher
    before and after QAT; the hybrid's int8 front rows card ==
    CPU, its head card vs CPU (BF16_HEAD_TOL), detect_batch ms at
    MODES_TIMING_B beside the f32-guard bf16 at the same depth; the FI
    hybrid embed card vs CPU (MODES_FI_TOL) and img/s beside the plain bf16
    embed; held-out AP50 with bootstrap intervals of the four served CSVs
    (printed, not gated). Returns (the launches of the main path, the
    numbers)."""
    import glob

    from face_vijnana_yolov3_tpu_torch import kernels
    from face_vijnana_yolov3_tpu_torch.api import face_detection as fdm
    from face_vijnana_yolov3_tpu_torch.api import face_identification as fim
    from face_vijnana_yolov3_tpu_torch.api.config import Conf, FdConf
    from face_vijnana_yolov3_tpu_torch.evals.detection import map_sweep
    from face_vijnana_yolov3_tpu_torch.models import qat, quant
    from face_vijnana_yolov3_tpu_torch.models.detector import head_conv
    from face_vijnana_yolov3_tpu_torch.ops import (  # noqa: F401  (register the wrappers)
        block_int8,
        conv_int8,
        front_fused,
        nms_sweep,
    )
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_host
    from face_vijnana_yolov3_tpu_torch.scripts.qat_conv_exactness import conv_exactness
    from face_vijnana_yolov3_tpu_torch.scripts.release_ap import bootstrap_ap50

    fdm.DEBUG = fim.DEBUG = False
    S = IMAGE_SIZE
    work = os.path.join(tmp, "release")
    valdir = os.path.join(work, "valset")
    ckpt = os.path.join(work, "fd_ckpt_qat.pt")

    def letterboxed(files):
        return np.asarray([letterbox_host(imread(f) / 255, S, "cubic")[0] for f in files],
                          np.float32)

    x_cal = letterboxed(sorted(glob.glob(os.path.join(work, "tr_*.jpg")))[:MODES_CALIB])
    x_held = letterboxed(sorted(glob.glob(os.path.join(valdir, "*.jpg")))[:MODES_HELD])

    def conf(tag, **kw):
        c = FdConf(test_path=valdir, model_loading=True, model_path=ckpt,
                   output_file_path=os.path.join(work, f"modes_{tag}.csv"), **kw)
        c.nn_arch.image_size = S
        return c

    def counts():
        torch.cuda.synchronize()
        return {k.__name__: k.launches for k in kernels.LAUNCH_COUNTERS}

    def moved(before):
        return {k: v - before[k] for k, v in counts().items()}

    for k in kernels.LAUNCH_COUNTERS:
        k.launches = 0
    rec: dict = {}
    # (a) distillation QAT: calibrate_int8 runs qat.distill_folded, timed here.
    distilled = {}
    real_distill = qat.distill_folded

    def timed_distill(*a, **kw):
        t0 = time.perf_counter()
        out = real_distill(*a, **kw)
        torch.cuda.synchronize()
        distilled.update(s=time.perf_counter() - t0, folded=out[0])
        return out

    qat.distill_folded = timed_distill
    try:
        fq = fdm.FaceDetectorPipeline(
            conf("qat", int8_qat_steps=MODES_QAT_STEPS, int8_pallas_blocks=True),
            precision="int8", device=dev)
        t0 = time.perf_counter()
        fq.calibrate_int8(x_cal)
        calib_s = time.perf_counter() - t0
    finally:
        qat.distill_folded = real_distill
    a0 = counts()
    fq.test()
    mv = {"qat": moved(a0)}
    ptq = fdm.FaceDetectorPipeline(conf("ptq", int8_pallas_blocks=True), precision="int8",
                                   device=dev)
    ptq.test()
    # (b) the int8 front guard, and the f32-guard bf16 beside it.
    hyb, plain = {}, {}
    for depth in MODES_DEPTHS:
        a0 = counts()
        hyb[depth] = fdm.FaceDetectorPipeline(
            conf(f"hybrid{depth}", bf16_front_mode="int8", bf16_f32_front=depth),
            precision="bfloat16", device=dev)
        hyb[depth].test()
        mv[f"hybrid{depth}"] = moved(a0)
    plain[2] = fdm.FaceDetectorPipeline(conf("bf16_guard2", bf16_f32_front=2),
                                        precision="bfloat16", device=dev)
    plain[2].test()
    # (c) the FI embed with the int8 guard.
    def fi_conf(mode):
        c = Conf()
        for sub in (c.fi_conf, c.fd_conf):
            sub.weights_path = os.path.join(tmp, "missing.weights")
            sub.nn_arch.image_size = S
        c.fi_conf.bf16_front_mode = mode
        return c

    crops = rng.uniform(size=(MODES_FI_CROPS, S, S, 3)).astype(np.float32)
    a0 = counts()
    fi = fim.FaceIdentifierPipeline(fi_conf("int8"), precision="bfloat16", device=dev,
                                    seed=SEED)
    emb = fi.embed(crops)
    mv["fi_hybrid"] = moved(a0)
    launches = counts()
    print(f"[modes] main path on {card}: QAT int8 ({MODES_QAT_STEPS} steps), PTQ int8, "
          f"the int8 guard at depths {MODES_DEPTHS} and the f32 guard at 2 served the "
          f"{len(os.listdir(valdir)) - 1} val JPEGs; the FI hybrid embedded "
          f"{MODES_FI_CROPS} crops; launches {launches}; by run {mv}")
    if min(launches[k] for k in ("nms_sweep", "conv_int8", "block_int8")) == 0:
        raise AssertionError(f"[modes] the main path skipped a kernel: {launches}")
    for depth in MODES_DEPTHS:
        if min(mv[f"hybrid{depth}"][k] for k in ("nms_sweep", "conv_int8")) == 0:
            raise AssertionError(f"[modes] the int8 guard at depth {depth} skipped A0 or B")
    if mv["fi_hybrid"]["conv_int8"] == 0 or mv["qat"]["block_int8"] == 0:
        raise AssertionError(f"[modes] a run skipped its int8 kernel: {mv}")

    # (a) checks: the refined int8 trunk card == CPU; fake-quant vs served head;
    # head MSE against the f32 teacher before and after the distillation.
    ops = fq.model.ops
    q = fq._qparams
    q_cpu = quant.to_device(q, "cpu")
    x_chk = torch.from_numpy(x_held[:MODES_CPU_B])
    with torch.inference_mode():
        t_card = quant.apply_graph_quant(q, x_chk.to(dev), ops, fused_blocks=True)["trunk"]
        t_cpu = quant.apply_graph_quant(q_cpu, x_chk, ops, fused_blocks=True)["trunk"]
    trunk_equal = torch.equal(t_card.cpu(), t_cpu)
    folded0 = fq.model.fold()
    q0 = quant.to_device(quant.quantize_folded(folded0, None, ops,
                                               act_scales=q["act_scales"]), dev)
    mse, fq_err, fq_trunk_equal = {}, 0.0, []
    with torch.inference_mode():
        for name, x in (("calibration", x_cal), ("held-out", x_held)):
            vals = {"before": [], "after": []}
            for s0 in range(0, len(x), 8):
                xb = torch.from_numpy(x[s0:s0 + 8]).to(dev)
                teacher = fq.model.apply_folded(folded0, xb, compute_dtype=torch.float32)
                served = fq.model.apply_quant(q, xb, fused_blocks=True)
                vals["before"].append(torch.square(
                    fq.model.apply_quant(q0, xb, fused_blocks=True) - teacher).sum())
                vals["after"].append(torch.square(served - teacher).sum())
                if name == "held-out" and s0 == 0:
                    fq_out = qat.apply_graph_fakequant(distilled["folded"], xb, ops,
                                                       q["act_scales"])["trunk"]
                    fq_head = head_conv(fq_out, distilled["folded"]["head"], torch.float32)
                    fq_err = float((fq_head - served).abs().max() / served.abs().max())
                    s_trunk = quant.apply_graph_quant(q, xb, ops, fused_blocks=True)["trunk"]
                    fq_trunk_equal = float((fq_out == s_trunk).float().mean())
                    fq_sums = conv_exactness(distilled["folded"], xb, ops, q["act_scales"])
            n_el = x.shape[0] * teacher[0].numel()
            mse[name] = {k: float(sum(v).item()) / n_el for k, v in vals.items()}
    losses = fq.int8_qat_losses
    print(f"[modes] distillation QAT on {card}: {MODES_QAT_STEPS} steps (lr "
          f"{fq.conf.int8_qat_lr}, tail {fq.conf.int8_qat_tail} blocks) in "
          f"{distilled['s']:.2f} s (calibrate_int8 {calib_s:.2f} s, {MODES_CALIB} images); "
          f"loss first {losses[0]:.6g} last {losses[-1]:.6g}; head MSE vs the f32 teacher "
          + "; ".join(f"{k}: before {v['before']:.6g} after {v['after']:.6g}"
                      for k, v in mse.items())
          + f"; refined int8 trunk card vs CPU torch.equal {trunk_equal}; fake-quant head "
          f"vs served head max |diff| / max |head| {fq_err:.4g} (tol {INT8_HEAD_TOL}), "
          f"fake-quant trunk equal to the served one on {fq_trunk_equal:.6f} of its "
          f"elements; its {fq_sums['convs']} convs differ from their exact sums on "
          f"{fq_sums['differ_within']} elements where Σ|x|·|k| ≤ 2^24 and "
          f"{fq_sums['differ_beyond']} where it is larger ({fq_sums['beyond']} such of "
          f"{fq_sums['elements']})")
    if not trunk_equal:
        raise AssertionError("[modes] the refined int8 trunk differs card vs CPU")
    if not fq_err <= INT8_HEAD_TOL:
        raise AssertionError("[modes] the fake-quant head disagrees with the served head")
    if fq_sums["differ_within"]:
        raise AssertionError("[modes] a fake-quant conv is inexact below 2^24")
    if fq_sums["differ_beyond"] == 0 and fq_trunk_equal != 1.0:
        raise AssertionError("[modes] the fake-quant trunk differs from the served one "
                             "with every conv exact")
    rec.update(qat_distill_s=distilled["s"], qat_calibrate_s=calib_s,
               qat_loss=(losses[0], losses[-1]), qat_head_mse=mse, qat_fq_head_err=fq_err,
               qat_fq_trunk_equal=fq_trunk_equal, qat_fq_sums=fq_sums)
    del distilled, q0, folded0

    # (b) checks: front rows card == CPU, heads card vs CPU, detect_batch ms.
    cpu_model = fdm.FaceDetectorModel(image_size=S, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in fq.model.state_dict().items()})
    x32 = [rng.uniform(size=(MODES_TIMING_B, S, S, 3)).astype(np.float32) for _ in range(2)]
    for depth in MODES_DEPTHS:
        fd = hyb[depth]
        qh = fd._qparams
        cut = qh["tail_start"]
        front_ops = list(ops[:cut]) + [("output", "__cut")]
        qf = {k: v for k, v in qh.items() if k not in ("tail_start", "tail")}
        with torch.inference_mode():
            r_card = quant.apply_graph_quant(qf, x_chk.to(dev), front_ops)["__cut"].cpu()
            r_cpu = quant.apply_graph_quant(quant.to_device(qf, "cpu"), x_chk,
                                            front_ops)["__cut"]
            h_card = fd.model.apply_quant(qh, x_chk.to(dev)).cpu()
            h_cpu = cpu_model.apply_quant(quant.to_device(qh, "cpu"), x_chk)
        h_err = float((h_card - h_cpu).abs().max() / h_cpu.abs().max())
        if depth not in plain:
            plain[depth] = fdm.FaceDetectorPipeline(conf(f"bf16_guard{depth}",
                                                         bf16_f32_front=depth),
                                                    precision="bfloat16", device=dev)
        ms = {}
        for label, pipe in (("int8 guard", fd), ("f32 guard", plain[depth])):
            nxt = itertools.cycle(x32).__next__
            ms[label] = cuda_ms(lambda pipe=pipe, nxt=nxt: pipe.detect_batch(nxt()), 8,
                                warmup=2)
            rec[f"hybrid{depth}_{label.split()[0]}_detect_ms"] = float(np.median(ms[label]))
        int8_convs = sorted(int(k[5:]) for k in qh if k.startswith("conv_"))
        print(f"[modes] int8 front guard, depth {depth}, on {card}: tail_start {cut}, int8 "
              f"convs {int8_convs}; front rows card vs CPU torch.equal "
              f"{torch.equal(r_card, r_cpu)}; head card vs CPU max |diff| / max |head| "
              f"{h_err:.4g} (tol {BF16_HEAD_TOL}); detect_batch b{MODES_TIMING_B}: int8 "
              f"guard {quartiles(ms['int8 guard'])}, f32 guard {quartiles(ms['f32 guard'])}")
        if not torch.equal(r_card, r_cpu) or not h_err <= BF16_HEAD_TOL:
            raise AssertionError(f"[modes] the int8 guard at depth {depth} disagrees card "
                                 "vs CPU")
        rec[f"hybrid{depth}_head_err"] = h_err
    del x32, cpu_model

    # (c) checks: the FI hybrid embed card vs CPU on the card's qparams; img/s.
    cpu_fi = fim.FaceIdentifierPipeline(fi_conf("int8"), precision="bfloat16",
                                        device="cpu", seed=SEED)
    cpu_fi._q_embed = quant.to_device(fi._q_embed, "cpu")
    e_err = float(np.abs(cpu_fi.embed(crops[:MODES_FI_CPU]) - emb[:MODES_FI_CPU]).max())
    fi_plain = fim.FaceIdentifierPipeline(fi_conf("f32"), precision="bfloat16", device=dev,
                                          seed=SEED)
    crops_dev = torch.from_numpy(crops).to(dev)
    emb_ms = {label: cuda_ms(lambda p=p: p.embed_device(crops_dev), 8, warmup=2)
              for label, p in (("int8 guard", fi), ("f32 guard", fi_plain))}
    img_s = {k: MODES_FI_CROPS / (float(np.median(v)) / 1e3) for k, v in emb_ms.items()}
    print(f"[modes] FI bf16 embed with the int8 guard (tail_start "
          f"{fi._q_embed['tail_start']}) on {card}: {MODES_FI_CPU} of {MODES_FI_CROPS} rows "
          f"card vs CPU max |diff| {e_err:.4g} (tol {MODES_FI_TOL}); embed of "
          f"{MODES_FI_CROPS} crops: int8 guard {img_s['int8 guard']:.1f} img/s, f32 guard "
          f"{img_s['f32 guard']:.1f} img/s")
    if not e_err <= MODES_FI_TOL:
        raise AssertionError("[modes] the FI hybrid embed disagrees card vs CPU")
    rec.update(fi_embed_err=e_err, fi_embed_img_s=img_s)
    del fi, cpu_fi, fi_plain, crops_dev

    # (d) held-out AP of the four served CSVs.
    gt = os.path.join(valdir, "validation.csv")
    aps = {}
    for tag in ("qat", "ptq", "hybrid2", "bf16_guard2"):
        sol = os.path.join(work, f"modes_{tag}.csv")
        row = {"rows": sum(1 for _ in open(sol))}
        try:
            with contextlib.redirect_stdout(io.StringIO()):  # its per-IoU lines
                row["ap50"] = float(map_sweep(gt, sol, out_h5=None)[2][0])
            row["ci95"] = bootstrap_ap50(gt, sol, RELEASE_RESAMPLES)
        except ValueError as e:  # nothing to score: no AP, and the reason
            if "to score" not in str(e):
                raise
            row.update(ap50=None, unscored=("no detections to score" if "empty" in str(e)
                                            else "no detection overlaps a face"))
        aps[tag] = row

    def ap_text(v):
        if v["ap50"] is None:
            return f"AP50 none ({v['unscored']}, {v['rows']} rows)"
        return (f"AP50 {v['ap50']:.4f} (95 % CI {v['ci95'][0]:.4f}-{v['ci95'][1]:.4f}, "
                f"{v['rows']} rows)")

    print(f"[modes] held-out AP50 on phase 14's checkpoint (its reduced recipe ends near "
          f"AP 0: these rows check bookkeeping only, not accuracy): "
          + "; ".join(f"{k} {ap_text(v)}" for k, v in aps.items())
          + f"; PTQ tail {ptq.int8_tail_chosen}")
    rec["aps"] = aps
    del fq, ptq, hyb, plain
    torch.cuda.empty_cache()
    return launches, rec


def modes_phase_fresh(tmp: str) -> tuple[dict, dict]:
    """Phase 16 in a fresh process, as phase 15: its lines passed through;
    returns (the launches of its main path, its numbers)."""
    out = os.path.join(tmp, "modes_phase.json")
    code = ("import json, numpy as np, torch, chip_smoke as cs; "
            "from face_vijnana_yolov3_tpu_torch import kernels; kernels.build(); "
            f"r = cs.modes_phase({tmp!r}, cs.nvidia_smi(), torch.device(cs.DEVICE), "
            f"np.random.default_rng(cs.SEED + 16)); json.dump(r, open({out!r}, 'w'))")
    sys.stdout.flush()
    proc = subprocess.run([sys.executable, "-c", code], timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"[modes] the fresh process failed (exit {proc.returncode})")
    with open(out) as f:
        launches, rates = json.load(f)
    return launches, rates


def _run_steps(step, carry, feeds):
    """`step` over `feeds` from `carry` → (the last carry, the losses)."""
    losses = []
    for feed in feeds:
        *carry, loss = step(*carry, *feed)
        losses.append(loss)
    return carry, losses


def _carry_diff(got, want) -> tuple[int, int]:
    """(tensors that differ, tensors) between two carries of a step."""
    from face_vijnana_yolov3_tpu_torch.train import trainer

    a, b = trainer._carry_leaves(got, want), trainer._carry_leaves(want, want)
    return sum(not torch.equal(x, y) for x, y in zip(a, b)), len(b)


def _one_graph(programs) -> bool:
    """The cache holds one program, and it is a captured graph."""
    return len(programs) == 1 and all(g is not None for _sig, g in programs._programs.values())


def _step_ms(step, carry, feeds) -> list[float]:
    """ms a step: two warm-up steps, then TP_TIMING_WINDOWS windows of
    TP_TIMING_STEPS steps (cycling `feeds`), each between two CUDA events."""
    carry, nxt = list(carry), itertools.cycle(feeds).__next__

    def advance():
        carry[:] = step(*carry, *nxt())[:-1]

    for _ in range(2):
        advance()
    times = []
    for _ in range(TP_TIMING_WINDOWS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TP_TIMING_STEPS):
            advance()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / TP_TIMING_STEPS)
    return times


def _busy(step, carry, feeds) -> dict:
    """`device_trace` of PROGRAM_BUSY_REPS steps of `step` from `carry`."""
    carry, nxt = list(carry), itertools.cycle(feeds).__next__

    def advance():
        carry[:] = step(*carry, *nxt())[:-1]

    return device_trace(advance, PROGRAM_BUSY_REPS)


def train_programs_phase(tmp, card, dev):
    """The captured training programs on the card (phase 17, TP_*), on phase
    14's set and checkpoint (tmp/release): eager vs replay over TP_STEPS
    steps for the detector cases, the semi-hard triplet step and
    distillation QAT (every carry tensor and loss torch.equal, one captured
    graph per step kind); two seeded train_detector runs with deterministic
    algorithms (equal checkpoints) and without (differences printed); step
    times eager vs replay with deterministic algorithms on and off, peak
    memory, triplets/s, distillation s a step, the busy share. Returns (the
    kernel launches of the phase, which reaches no kernel of the port, its
    numbers)."""
    from face_vijnana_yolov3_tpu_torch import kernels, profile_train
    from face_vijnana_yolov3_tpu_torch.convert import (
        identifier_params_from_jax,
        params_from_jax,
    )
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import load_checkpoint, load_opt_state
    from face_vijnana_yolov3_tpu_torch.core.programs import ProgramCache
    from face_vijnana_yolov3_tpu_torch.data.uccs import DetectionDataset
    from face_vijnana_yolov3_tpu_torch.models import darknet, qat, quant
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel, head_conv
    from face_vijnana_yolov3_tpu_torch.models.identifier import FaceIdentifierModel
    from face_vijnana_yolov3_tpu_torch.ops import (  # noqa: F401  (register the wrappers)
        block_int8,
        conv_int8,
        front_fused,
        nms_sweep,
    )
    from face_vijnana_yolov3_tpu_torch.train import optimizer, trainer

    t_phase = time.perf_counter()
    for k in kernels.LAUNCH_COUNTERS:
        k.launches = 0
    S = IMAGE_SIZE
    work = os.path.join(tmp, "release")
    ds = DetectionDataset(work, image_size=S, grid=S // 32, cache="disk")
    images, gts = ds.batch(0, len(ds))
    n = len(images)
    model = FaceDetectorModel(image_size=S, device=dev)
    sd = params_from_jax(*model.init_params(SEED + 17))
    p0, s0 = darknet.split_state_dict({k: v.to(dev) for k, v in sd.items()})
    rates: dict = {}

    def det_feeds(b, dtype, count):
        """`count` device-resident batches of b rows, the set cycled."""
        out = []
        for i in range(count):
            rows = (np.arange(b) + i * b) % n
            out.append((torch.from_numpy(images[rows]).to(dev).to(dtype),
                        torch.from_numpy(gts[rows]).to(dev), torch.ones(b, device=dev)))
        return out

    # (a) eager vs replay, detector steps.
    for label, dtype, fq, b in TP_CASES:
        feeds = det_feeds(b, dtype, TP_STEPS)
        opt = optimizer.KerasAdam(TP_LR)
        step = trainer.make_train_step(model, opt, compute_dtype=dtype, fakequant=fq)
        carry0 = (p0, s0, opt.init(p0))
        programs = ProgramCache(dev, train=True)
        with trainer.deterministic():
            want, w_losses = _run_steps(step, carry0, feeds)
            got, g_losses = _run_steps(trainer.program_step(
                programs, ("detector", str(dtype), fq), step, 3), carry0, feeds)
        torch.cuda.synchronize()
        diff, total = _carry_diff(got, want)
        same_loss = all(torch.equal(a, c) for a, c in zip(g_losses, w_losses))
        print(f"[train-programs] detector {label} b={b} at {S}², {TP_STEPS} steps, eager vs "
              f"replay on {card}: {diff} of {total} param/BN/Adam tensors differ, losses "
              f"equal {same_loss} (last {float(g_losses[-1]):.6f}); one captured graph "
              f"{_one_graph(programs)}")
        if diff or not same_loss or not _one_graph(programs):
            raise AssertionError(f"[train-programs] detector {label}: replay != eager")
        del feeds, programs, want, got, step
        torch.cuda.empty_cache()

    # (b) eager vs replay, the semi-hard triplet step (f32, b8).
    fi_model = FaceIdentifierModel(image_size=S, device=dev)
    fi_params, fi_state = fi_model.init_params(SEED + 18)
    darknet.perturb_batchnorm(fi_params, fi_state, fi_model.ops, SEED + 19)
    fp0, fs0 = darknet.split_state_dict(
        {k: v.to(dev) for k, v in identifier_params_from_jax(fi_params, fi_state).items()})
    del fi_params, fi_state
    rng = np.random.default_rng(SEED + 17)

    def triplet_feeds(b, dtype, count, semi):
        out = []
        for _ in range(count):
            apn = tuple(torch.from_numpy(rng.uniform(size=(b, S, S, 3)).astype(np.float32))
                        .to(dev).to(dtype) for _ in range(3))
            feed = (*apn, torch.ones(b, device=dev))
            if semi:
                sa = rng.integers(0, 4, b).astype(np.int32)
                sn = (sa + 1 + rng.integers(0, 3, b).astype(np.int32)) % 4
                feed += (torch.from_numpy(sa).to(dev), torch.from_numpy(sn).to(dev))
            out.append(feed)
        return out

    feeds = triplet_feeds(TP_TRIPLET_B, torch.float32, TP_STEPS, True)
    opt = optimizer.KerasAdam(TP_LR)
    step = trainer.make_triplet_step(fi_model, opt, mining="semi_hard")
    carry0 = (fp0, fs0, opt.init(fp0))
    programs = ProgramCache(dev, train=True)
    with trainer.deterministic():
        want, w_losses = _run_steps(step, carry0, feeds)
        got, g_losses = _run_steps(trainer.program_step(
            programs, ("identifier", "torch.float32", "semi_hard", False, False), step, 3),
            carry0, feeds)
    torch.cuda.synchronize()
    diff, total = _carry_diff(got, want)
    same_loss = all(torch.equal(a, c) for a, c in zip(g_losses, w_losses))
    print(f"[train-programs] semi-hard triplet step b={TP_TRIPLET_B} ({3 * TP_TRIPLET_B} "
          f"images) at {S}², {TP_STEPS} steps, eager vs replay: {diff} of {total} tensors "
          f"differ, losses equal {same_loss} (last {float(g_losses[-1]):.6f}); one captured "
          f"graph {_one_graph(programs)}")
    if diff or not same_loss or not _one_graph(programs):
        raise AssertionError("[train-programs] the semi-hard triplet step: replay != eager")
    del feeds, programs, want, got, step
    torch.cuda.empty_cache()

    # (c) eager vs replay, distillation QAT on phase 14's checkpoint.
    fd = FaceDetectorModel(image_size=S, device=dev)
    fd.load_state_dict(load_checkpoint(os.path.join(work, "fd_ckpt_qat.pt")))
    folded = fd.fold()
    x_cal = torch.from_numpy(images[:MODES_CALIB]).to(dev)
    act_scales = quant.calibrate_folded(folded, x_cal[:16], fd.ops)
    real_program_step = trainer.program_step
    distill = {}
    for eager in (False, True):
        rec = {"ms": []}

        def spy(programs, key, step, n_carry, rec=rec, eager=eager):
            rec["programs"] = programs
            run = step if eager else real_program_step(programs, key, step, n_carry)

            def timed(*args):
                t0 = time.perf_counter()
                rec["last"] = run(*args)
                torch.cuda.synchronize()
                rec["ms"].append((time.perf_counter() - t0) * 1e3)
                return rec["last"]

            return timed

        trainer.program_step = spy
        try:
            refined, losses = qat.distill_folded(
                folded, x_cal, fd.ops, act_scales=act_scales,
                head_fn=lambda outs, prm: head_conv(outs["trunk"], prm["head"], torch.float32),
                steps=TP_STEPS, lr=TP_QAT_LR, tail_blocks=TP_QAT_TAIL)
        finally:
            trainer.program_step = real_program_step
        distill["eager" if eager else "replay"] = (refined, losses, rec)
    (r_ref, r_loss, r_rec), (e_ref, e_loss, e_rec) = distill["replay"], distill["eager"]
    diff = sum(not torch.equal(r_ref[k][m], e_ref[k][m]) for k in e_ref for m in e_ref[k])
    c_diff, c_total = _carry_diff(r_rec["last"][:-1], e_rec["last"][:-1])
    rates["distill_s_step_eager"] = float(np.median(e_rec["ms"][1:])) / 1e3
    rates["distill_s_step_replay"] = float(np.median(r_rec["ms"][1:])) / 1e3
    rates["distill_first_call_s_replay"] = r_rec["ms"][0] / 1e3
    print(f"[train-programs] distillation QAT on phase 14's checkpoint ({MODES_CALIB} "
          f"images, b8, lr {TP_QAT_LR:g}, the last {TP_QAT_TAIL} blocks), {TP_STEPS} steps, "
          f"eager vs replay on {card}: {diff} refined tensors and {c_diff} of {c_total} "
          f"leaf/Adam tensors differ, losses equal {r_loss == e_loss} (last "
          f"{r_loss[-1]:.4e}); s a step eager {rates['distill_s_step_eager']:.4f}, replay "
          f"{rates['distill_s_step_replay']:.4f} (the first replayed call, capture included, "
          f"{rates['distill_first_call_s_replay']:.3f} s); one captured graph "
          f"{_one_graph(r_rec['programs'])}")
    if diff or c_diff or r_loss != e_loss or not _one_graph(r_rec["programs"]):
        raise AssertionError("[train-programs] distillation: replay != eager")
    del distill, r_rec, e_rec, r_ref, e_ref, folded, fd, x_cal
    torch.cuda.empty_cache()

    # (d) two seeded train_detector runs, with and without deterministic algorithms.
    hps = {"lr": TP_LR, "beta_1": 0.99, "beta_2": 0.99, "decay": 0.0,
           "epochs": TP_RUN_EPOCHS, "batch_size": TP_RUN_B}
    for det in (True, False):
        ckpts, hist = [], []
        for run in ("a", "b"):
            p, s_ = darknet.split_state_dict({k: v.to(dev) for k, v in sd.items()})
            path = os.path.join(tmp, f"train_programs_{run}_{det}.pt")
            if det:
                _, _, losses = trainer.train_detector(model, p, s_, ds, dict(hps),
                                                      log_every=0, checkpoint_path=path)
            else:
                with profile_train.flags("off"):
                    _, _, losses = trainer.train_detector.__wrapped__(
                        model, p, s_, ds, dict(hps), log_every=0, checkpoint_path=path)
            ckpts.append((load_checkpoint(path), load_opt_state(path)))
            hist.append(losses)
        (sa, oa), (sb, ob) = ckpts
        ta = list(sa.values()) + [oa["count"], *oa["mu"].values(), *oa["nu"].values()]
        tb = [sb[k] for k in sa] + [ob["count"], *(ob["mu"][k] for k in oa["mu"]),
                                    *(ob["nu"][k] for k in oa["mu"])]
        diff = sum(not torch.equal(x, y) for x, y in zip(ta, tb))
        loss_diff = sum(x != y for x, y in zip(*hist))
        tag = "on" if det else "off"
        rates[f"two_runs_differing_tensors_det_{tag}"] = diff
        rates[f"two_runs_differing_losses_det_{tag}"] = loss_diff
        print(f"[train-programs] two train_detector runs ({TP_RUN_EPOCHS} epochs at "
              f"b={TP_RUN_B} on phase 14's {n} images, f32, one seed), deterministic "
              f"algorithms {tag}: {diff} of {len(ta)} checkpoint tensors (params, BN, Adam) "
              f"and {loss_diff} of {len(hist[0])} losses differ"
              + ("" if det else " (printed, not gated)"))
        if det and (diff or loss_diff):
            raise AssertionError("[train-programs] two seeded runs ended on different "
                                 "checkpoints with deterministic algorithms")
    del ckpts
    torch.cuda.empty_cache()

    # (e) step times, eager vs replay, deterministic algorithms on and off.
    for label, dtype, fq, b in TP_TIMING:
        feeds = det_feeds(b, dtype, 2)
        opt = optimizer.KerasAdam(TP_LR)
        step = trainer.make_train_step(model, opt, compute_dtype=dtype, fakequant=fq)
        carry0 = (p0, s0, opt.init(p0))
        for det in (True, False):
            rec = {}
            with profile_train.flags("on" if det else "off"):
                for path in ("eager", "replay"):
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    fn = step if path == "eager" else trainer.program_step(
                        ProgramCache(dev, train=True), ("detector", str(dtype), fq), step, 3)
                    ms = _step_ms(fn, carry0, feeds)
                    rec[path] = dict(ms=ms, img_s=b / (np.median(ms) / 1e3),
                                     peak_gib=torch.cuda.max_memory_allocated() / 2**30)
                    if label == "f32" and b == 16 and det:
                        t = _busy(fn, carry0, feeds)
                        rec[path]["busy"], rec[path]["trace"] = t["busy"], t
                    del fn  # the program and its pool go before the next one
            name = f"{label}_b{b}_det_{'on' if det else 'off'}"
            rates[name] = rec
            busy = "".join(f"; busy {p} {rec[p]['busy']:.1%} (wall {rec[p]['trace']['wall_ms']:.2f}, "
                           f"busy {rec[p]['trace']['busy_ms']:.2f} ms)"
                           for p in ("eager", "replay") if "busy" in rec[p])
            print(f"[train-programs] train_img_s {label} b={b} at {S}², deterministic "
                  f"algorithms {'on' if det else 'off'}, on {card}: eager "
                  f"{rec['eager']['img_s']:.1f} img/s ({quartiles(rec['eager']['ms'])} a step, "
                  f"peak {rec['eager']['peak_gib']:.1f} GiB), replay "
                  f"{rec['replay']['img_s']:.1f} img/s ({quartiles(rec['replay']['ms'])}, peak "
                  f"{rec['replay']['peak_gib']:.1f} GiB){busy}")
        del feeds, step
        torch.cuda.empty_cache()

    # (f) triplets/s, eager vs replay (bf16, random mining).
    b = TP_TRIPLET_TIMING_B
    feeds = triplet_feeds(b, torch.bfloat16, 2, False)
    opt = optimizer.KerasAdam(TP_LR)
    step = trainer.make_triplet_step(fi_model, opt, compute_dtype=torch.bfloat16)
    carry0 = (fp0, fs0, opt.init(fp0))
    rec = {}
    with trainer.deterministic():
        for path in ("eager", "replay"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fn = step if path == "eager" else trainer.program_step(
                ProgramCache(dev, train=True),
                ("identifier", "torch.bfloat16", "random", False, False), step, 3)
            ms = _step_ms(fn, carry0, feeds)
            rec[path] = dict(ms=ms, triplets_s=b / (np.median(ms) / 1e3),
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            del fn
    rates[f"triplets_bf16_b{b}"] = rec
    print(f"[train-programs] triplets/s bf16 b={b} ({3 * b} images a step) at {S}², "
          f"deterministic algorithms on, on {card}: eager {rec['eager']['triplets_s']:.1f} "
          f"({quartiles(rec['eager']['ms'])}, peak {rec['eager']['peak_gib']:.1f} GiB), "
          f"replay {rec['replay']['triplets_s']:.1f} ({quartiles(rec['replay']['ms'])}, "
          f"peak {rec['replay']['peak_gib']:.1f} GiB)")
    del feeds, step, fi_model
    torch.cuda.empty_cache()

    # (g) finalize_bn_stats: one inference program a batch shape (the JAX
    # `recal`) vs the same forwards run eagerly.
    class Eager(ProgramCache):
        def run(self, key, fn, *inputs, donate=0):
            with self._mode():
                return fn(*inputs)

    recal = {}
    for path in ("eager", "replay"):
        trainer.ProgramCache = Eager if path == "eager" else ProgramCache
        try:
            t0 = time.perf_counter()
            recal[path] = trainer.finalize_bn_stats(model, p0, s0, ds, TP_RECAL_B)
            torch.cuda.synchronize()
            rates[f"finalize_bn_s_{path}"] = time.perf_counter() - t0
        finally:
            trainer.ProgramCache = ProgramCache
    diff = sum(not torch.equal(recal["eager"][k], v) for k, v in recal["replay"].items())
    print(f"[train-programs] finalize_bn_stats over phase 14's {n} images at b="
          f"{TP_RECAL_B} ({ds.steps(TP_RECAL_B)} batches, the last of "
          f"{n - (ds.steps(TP_RECAL_B) - 1) * TP_RECAL_B}) on {card}: {diff} of "
          f"{len(recal['eager'])} statistics differ, replay vs eager; eager "
          f"{rates['finalize_bn_s_eager']:.2f} s, programs {rates['finalize_bn_s_replay']:.2f} s "
          f"(the two captures included)")
    if diff:
        raise AssertionError("[train-programs] finalize_bn_stats: replay != eager")
    del recal

    # (h) "auto" calibration of phase 14's checkpoint on the first
    # CALIB_IMAGES images of its calibration batch (the CPU's f32 forward
    # at 416² takes ~8 s an image), card vs CPU: the forwards differ in
    # their sums, so the choices and the int8 weights are printed, not gated.
    fd = FaceDetectorModel(image_size=S, device=dev)
    fd.load_state_dict(load_checkpoint(os.path.join(work, "fd_ckpt_qat.pt")))
    folded = fd.fold()
    folded_cpu = {k: {m: t.cpu() for m, t in v.items()} for k, v in folded.items()}
    x_auto = images[:CALIB_IMAGES]
    auto = {d: quant.calibrate_folded(f, torch.from_numpy(x_auto).to(d), fd.ops,
                                      percentile="auto")
            for d, f in ((dev, folded), ("cpu", folded_cpu))}
    same_ch = sum(int((a == b).sum()) for a, b in zip(auto[dev], auto["cpu"]))
    total_ch = sum(b.size for b in auto["cpu"])
    q = {d: quant.quantize_folded(f, None, fd.ops, act_scales=auto[d])
         for d, f in ((dev, folded), ("cpu", folded_cpu))}
    convs = [k for k in q["cpu"] if k.startswith("conv_")]
    same_k = sum(torch.equal(q[dev][k]["kernel_q"].cpu(), q["cpu"][k]["kernel_q"])
                 for k in convs)
    rates["auto_channels_equal"] = [same_ch, total_ch]
    rates["auto_kernels_q_equal"] = [same_k, len(convs)]
    print(f"[calib] \"auto\" calibration of phase 14's checkpoint on the first "
          f"{CALIB_IMAGES} images of its calibration batch, card vs CPU (printed, not "
          f"gated: the f32 forwards sum in other "
          f"orders): {same_ch} of {total_ch} channel scales equal; int8 kernels equal "
          f"in {same_k} of {len(convs)} convs")
    del folded_cpu, folded, fd, auto, q
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels.LAUNCH_COUNTERS}
    print(f"[train-programs] kernel launches of the phase {launches} (the training "
          f"steps reach no kernel of the port); phase {time.perf_counter() - t_phase:.0f} s")
    return launches, rates


def train_programs_phase_fresh(tmp: str) -> tuple[dict, dict]:
    """Phase 17 in a fresh process, as phases 15 and 16: its lines passed
    through; returns (its kernel launches, its numbers)."""
    out = os.path.join(tmp, "train_programs_phase.json")
    code = ("import json, torch, chip_smoke as cs; "
            f"r = cs.train_programs_phase({tmp!r}, cs.nvidia_smi(), torch.device(cs.DEVICE)); "
            f"json.dump(r, open({out!r}, 'w'))")
    sys.stdout.flush()
    proc = subprocess.run([sys.executable, "-c", code], timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"[train-programs] the fresh process failed (exit "
                             f"{proc.returncode})")
    with open(out) as f:
        launches, rates = json.load(f)
    return launches, rates


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this smoke runs on the card only",
              file=sys.stderr)
        return 2
    from face_vijnana_yolov3_tpu_torch import kernels
    from face_vijnana_yolov3_tpu_torch.api import face_detection as fdm
    from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
    from face_vijnana_yolov3_tpu_torch.core.checkpoints import (
        load_checkpoint,
        save_checkpoint,
    )
    from face_vijnana_yolov3_tpu_torch.models import darknet, quant
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel, head_conv
    from face_vijnana_yolov3_tpu_torch.ops.decode import decode_face_head
    from face_vijnana_yolov3_tpu_torch.ops.front_fused import apply_graph_folded_front
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import (
        letterbox_geometry,
        letterbox_host,
    )
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import (
        nms_sweep,
        nms_sweep_reference,
    )
    from face_vijnana_yolov3_tpu_torch.ops.postprocess import (
        face_postprocess_batch,
        select_candidates,
    )
    from face_vijnana_yolov3_tpu_torch.ops.resize import (
        letterbox_device_matmul,
        letterbox_matrices,
    )

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    t_start = time.perf_counter()
    fdm.DEBUG = False  # no per-image progress lines from evaluate/test

    # 1. device
    card = nvidia_smi()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"default TF32 flags: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # 2. build
    path, build_s = kernels.build()
    lib = kernels.load()
    entry_points = [n for n in ("fvy_nms_sweep", "fvy_conv_int8", "fvy_block_int8",
                                "fvy_front_fused") if hasattr(lib, n)]
    print(f"[build] {path.name} built in {build_s:.2f} s; entry points {entry_points}")
    if len(entry_points) != 4:
        raise AssertionError("the library lacks a kernel")

    # 3. kernels vs plain versions, then their times
    max_err = 0.0
    cases = [(kind, b, n) for kind in ("float", "integer", "degenerate")
             for b in NMS_CHECK_B for n in NMS_CHECK_N]
    cases += [(kind, b, KERNEL_N) for kind in ("nonfinite", "absent", "ties")
              for b in NMS_CHECK_B]
    for kind, b, n in cases:
        boxes, scores = sorted_case(kind, b, n, rng)
        for th in ((0.45, 0.5) if n == KERNEL_N else (0.45,)):
            got = nms_sweep(boxes, scores, th)
            want = nms_sweep_reference(boxes, scores, th)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"nms_sweep != plain version ({kind}, B={b}, N={n}, "
                                     f"th {th})")
            max_err = max(max_err, float((got - want).abs().max()))
            if b == KERNEL_B and n in (KERNEL_N, 1024):
                print(f"[kernels] nms_sweep {kind} B={b} N={n} th={th}: torch.equal with "
                      f"the plain version; suppressed {int(((want == 0) & (scores > 0)).sum())} "
                      f"of {int((scores > 0).sum())} live rows")
    print(f"[kernels] nms_sweep: torch.equal with the plain version in all {len(cases)} "
          f"cases (B {NMS_CHECK_B} x N {NMS_CHECK_N} x float/integer/degenerate; "
          f"non-finite boxes, absent and tied scores at N={KERNEL_N})")
    nms_rec = {}
    for b in (KERNEL_B, NMS_TIMING_B2):
        boxes, scores = sorted_case("integer", b, KERNEL_N, rng)
        d_ms = graph_ms(lambda: nms_sweep(boxes, scores, 0.5))
        k_ms = cuda_ms(lambda: nms_sweep(boxes, scores, 0.5), 50)
        p_ms = cuda_ms(lambda: nms_sweep_reference(boxes, scores, 0.5), 20)
        kept = nms_sweep(boxes, scores, 0.5) > 0
        # IoU tests this input needs: each kept row i against every later row.
        pairs = int((kept * (KERNEL_N - 1 - torch.arange(KERNEL_N, device=dev))).sum())
        nms_bound, nms_bound_by = bound(
            b * KERNEL_N * (16 + 4 + 4),
            NMS_OPS_PER_PAIR * pairs + NMS_OPS_PER_BOX * b * KERNEL_N, PEAK_F32)
        nms_rec[b] = dict(ms=float(np.median(d_ms)), events_ms=float(np.median(k_ms)),
                          plain_ms=float(np.median(p_ms)), bound_ms=nms_bound,
                          bound_by=nms_bound_by)
        print(f"[kernels] nms_sweep B={b} N={KERNEL_N} on {card}: kernel {quartiles(d_ms)} "
              f"on the device, {quartiles(k_ms)} a call between events (host launch "
              f"included); plain {quartiles(p_ms)}; bound {nms_bound * 1e3:.3f} us by "
              f"{nms_bound_by} ({pairs} IoU tests); {int(kept.sum())} rows kept")
    nms_large = check_nms_large(card, rng)
    ops = darknet.trunk_graph()
    int8_err = check_int8_kernels(ops, rng)
    int8_rec = time_int8_kernels(ops, card, rng)
    front_err = check_front(rng)
    front_rec = time_front(ops, card, rng)
    torch.cuda.empty_cache()
    print(f"[kernels] done at {time.perf_counter() - t_start:.0f} s")

    # 4. slice: the CLI in test mode at 416², f32, batch 4
    with tempfile.TemporaryDirectory() as tmp:
        files = write_images(tmp, rng)
        model = FaceDetectorModel(image_size=IMAGE_SIZE)
        ckpt = os.path.join(tmp, "fd_random.pt")
        save_checkpoint(ckpt, params_from_jax(*model.init_params(SEED)),
                        meta={"seed": SEED})
        conf = os.path.join(tmp, "conf.json")
        csv = os.path.join(tmp, "solution_fd.csv")
        with open(conf, "w") as f:
            json.dump({"fd_conf": {
                "mode": "test", "test_path": tmp, "output_file_path": csv,
                "model_loading": True, "model_path": ckpt,
                "hps": {"face_conf_th": 0.05, "batch_size": 4},
                "nn_arch": {"image_size": IMAGE_SIZE},
            }}, f)
        nms_sweep.launches = 0
        fd = fdm.main([f"--conf={conf}"])
        torch.cuda.synchronize()
        f32_launches = nms_sweep.launches
        summary = check_csv(csv, len(files), "f32")
        print(f"[slice] CLI test mode: {summary}; nms_sweep launches {f32_launches}; "
              f"params on {next(fd.model.parameters()).device}; TF32 flags in "
              f"serving: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
              f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
        if f32_launches == 0:
            raise AssertionError("the CLI run never launched the nms_sweep kernel")
        if next(fd.model.parameters()).device.type != dev.type:
            raise AssertionError("the pipeline's parameters are not on the card")
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on in the f32 serving pipeline")

        # The device letterbox (detect_batch_fused) on the CLI's first batch.
        ims = [imread(f) for f in sorted(files)[:4]]
        geoms = [letterbox_geometry(*im.shape[:2], IMAGE_SIZE) for im in ims]
        max_h = max(im.shape[0] for im in ims)
        max_w = max(im.shape[1] for im in ims)
        staged = np.zeros((4, max_h, max_w, 3), np.uint8)
        for k, im in enumerate(ims):
            staged[k, : im.shape[0], : im.shape[1]] = im
        host_lb = np.asarray([letterbox_host(im / 255, IMAGE_SIZE, "cubic")[0]
                              for im in ims], np.float32)
        cv2_lb32 = np.asarray([letterbox_host((im / 255).astype(np.float32),
                                              IMAGE_SIZE, "cubic")[0] for im in ims])
        mats = [letterbox_matrices(g, max_h, max_w, IMAGE_SIZE) for g in geoms]
        dev_lb = letterbox_device_matmul(
            torch.from_numpy(staged).to(dev).float() * (1.0 / 255.0),
            torch.from_numpy(np.stack([m[0] for m in mats])).to(dev),
            torch.from_numpy(np.stack([m[1] for m in mats])).to(dev),
        ).cpu().numpy()
        lb_err = float(np.abs(dev_lb - cv2_lb32).max())
        f_cands, f_counts = fd.detect_batch_fused(staged, geoms)
        h_cands, h_counts = fd.detect_batch(host_lb)
        print(f"[slice] detect_batch_fused: counts {f_counts.tolist()} (host "
              f"letterbox {h_counts.tolist()}); device vs cv2 letterbox max |diff| "
              f"{lb_err:.3g} (tol {LETTERBOX_TOL})")
        if lb_err > LETTERBOX_TOL or not np.isfinite(f_cands).all():
            raise AssertionError("device letterbox disagrees with cv2")

        # The card's head vs the CPU's on 2 images, same weights.
        x = torch.from_numpy(host_lb[:2])
        with torch.inference_mode():
            head_gpu = fd.model(x.to(dev))
            cpu_model = FaceDetectorModel(image_size=IMAGE_SIZE, device="cpu")
            cpu_model.load_state_dict(load_checkpoint(ckpt))
            head_cpu = cpu_model(x)
        head_err = float((head_gpu.cpu() - head_cpu).abs().max())
        print(f"[slice] head (2, 13, 13, 6) card vs CPU: max |diff| {head_err:.3g}, "
              f"max |head| {float(head_cpu.abs().max()):.3g} (tol {HEAD_TOL})")
        if not torch.allclose(head_gpu.cpu(), head_cpu, rtol=HEAD_TOL, atol=HEAD_TOL):
            raise AssertionError("card head disagrees with the CPU head")

        # Kernel postprocess vs the plain one, on the card's decode of its head.
        with torch.inference_mode():
            head_b = fd.model(torch.from_numpy(host_lb).to(dev))
            cfg = fd._pp_cfg
            dec = decode_face_head(head_b, cfg.image_size, cfg.grid, cfg.conf_th)
            cands_k, counts_k = select_candidates(*dec, cfg)
            cands_p, counts_p = select_candidates(*(t.cpu() for t in dec), cfg)
            cpu_dec = decode_face_head(head_b.cpu(), cfg.image_size, cfg.grid,
                                       cfg.conf_th)
        torch.cuda.synchronize()
        dec_ulp = int(ulp_distance(dec[1].cpu().numpy(), cpu_dec[1].numpy()).max())
        print(f"[slice] postprocess, kernel vs plain sweep on the card's decode: "
              f"counts {counts_k.tolist()} vs {counts_p.tolist()}, cands "
              f"torch.equal {torch.equal(cands_k.cpu(), cands_p)}; (the card's vs "
              f"the CPU's decode of one head: scores up to {dec_ulp} ULP apart, expf)")
        if not (torch.equal(counts_k.cpu(), counts_p)
                and torch.equal(cands_k.cpu(), cands_p)):
            raise AssertionError("kernel postprocess disagrees with the plain one")
        print(f"[slice] done at {time.perf_counter() - t_start:.0f} s")

        # 5. int8: the slice's main path, then the bit-exact checks
        launches, fd8, calib_s = int8_slice(tmp, files, fdm, card, dev)
        print(f"[int8] done at {time.perf_counter() - t_start:.0f} s")

        # 6. bf16: the slice's main path, then the fused-front program
        bf16_launches, fdb = bf16_slice(tmp, files, fdm, card, dev)
        print(f"[bf16] done at {time.perf_counter() - t_start:.0f} s")
        torch.cuda.empty_cache()

    # 7. timing: detect_batch img/s over distinct inputs
    rates = {}
    runs = [("int8", fd8, b, None) for b in INT8_TIMING_BATCHES]
    runs += [("f32", fd, b, None) for b in F32_TIMING_BATCHES]
    runs += [("bf16", fdb, b, d) for d in BF16_DEPTHS for b in BF16_TIMING_BATCHES]
    for label, pipe, b, depth in runs:
        if depth is not None:
            pipe.conf.bf16_f32_front = depth
            label = f"bf16 guard depth {depth}"
        inputs = [rng.uniform(size=(b, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
                  for _ in range(3)]
        next_input = itertools.cycle(inputs).__next__
        ms = cuda_ms(lambda: pipe.detect_batch(next_input()), 8, warmup=2)
        rates[(label, b)] = b / (np.median(ms) / 1e3)
        with torch.inference_mode():
            xd = [torch.from_numpy(a).to(dev) for a in inputs[:2]]
            next_x = itertools.cycle(xd).__next__
            if label == "int8":
                fwd = {blocks: cuda_ms(lambda blocks=blocks: quant.apply_graph_quant(
                    pipe._qparams, next_x(), pipe.model.ops,
                    fused_blocks=blocks), 8, warmup=2) for blocks in (True, False)}
                heads = [pipe.model.apply_quant(pipe._qparams, t, fused_blocks=True)
                         for t in xd]
                fwd_txt = (f"int8 trunk, blocks on {quartiles(fwd[True])}; blocks "
                           f"off {quartiles(fwd[False])}")
            elif depth is not None:
                fwd_ms = cuda_ms(lambda: pipe._bf16_head(next_x(), depth), 8, warmup=2)
                heads = [pipe._bf16_head(t, depth) for t in xd]
                fwd_txt = f"trunk+head {quartiles(fwd_ms)}"
            else:
                fwd_ms = cuda_ms(lambda: pipe.model(next_x()), 8, warmup=2)
                heads = [pipe.model(t) for t in xd]
                fwd_txt = f"trunk+head {quartiles(fwd_ms)}"
            next_head = itertools.cycle(heads).__next__
            pp_ms = cuda_ms(lambda: face_postprocess_batch(next_head(), pipe._pp_cfg), 8)
        print(f"[timing] {label} detect_batch b={b} on {card}: "
              f"{rates[(label, b)]:.1f} img/s; detect_batch {quartiles(ms)}; "
              f"{fwd_txt}; postprocess {quartiles(pp_ms)}")
        del inputs, xd, heads
        torch.cuda.empty_cache()
    with torch.inference_mode():
        xd = [torch.from_numpy(rng.uniform(size=(FRONT_B, IMAGE_SIZE, IMAGE_SIZE, 3))
                               .astype(np.float32)).to(dev) for _ in range(2)]
        next_x = itertools.cycle(xd).__next__
        folded = fdb._folded_params()
        stock_ms = cuda_ms(lambda: fdb._bf16_head(next_x(), 0), 8, warmup=2)
        fused_ms = cuda_ms(lambda: head_conv(apply_graph_folded_front(
            folded, next_x(), fdb.model.ops)["trunk"].to(torch.bfloat16),
            folded["head"], torch.bfloat16), 8, warmup=2)
    print(f"[timing] bf16 trunk+head b={FRONT_B} on {card}: stock front (guard depth "
          f"0) {quartiles(stock_ms)}; fused front (apply_graph_folded_front) "
          f"{quartiles(fused_ms)}")
    del xd
    print(f"[timing] int8 calibration (32 images, one candidate) {calib_s:.2f} s; "
          f"done at {time.perf_counter() - t_start:.0f} s")
    del fd, fd8, fdb
    torch.cuda.empty_cache()

    # 8-10. serving above N = 1024, calibration, training
    with tempfile.TemporaryDirectory() as tmp:
        serve_large(tmp, fdm, card, rng)
        print(f"[serve] done at {time.perf_counter() - t_start:.0f} s")
        calib_rates = calib_phase(card, dev, rng)
        print(f"[calib] done at {time.perf_counter() - t_start:.0f} s")
        train_rates, train_launches = train_phase(tmp, fdm, card, dev)
        print(f"[train] done at {time.perf_counter() - t_start:.0f} s")
        torch.cuda.empty_cache()
        fi_launches, fi_rates = identify_phase(tmp, card, dev)
        print(f"[identify] done at {time.perf_counter() - t_start:.0f} s")
        torch.cuda.empty_cache()
        coco_launches, coco_rates, coco_detect8 = coco_phase(tmp, card, dev)
        print(f"[coco] done at {time.perf_counter() - t_start:.0f} s")
        torch.cuda.empty_cache()
        t_deploy = time.perf_counter()
        deploy_launches, deploy_rates = deploy_phase(tmp, card, dev, rng, coco_detect8)
        del coco_detect8
        print(f"[deploy] done at {time.perf_counter() - t_start:.0f} s (phase "
              f"{time.perf_counter() - t_deploy:.0f} s)")
        torch.cuda.empty_cache()
        t_release = time.perf_counter()
        release_launches, release_rates = release_phase(tmp, card, dev)
        print(f"[release] done at {time.perf_counter() - t_start:.0f} s (phase "
              f"{time.perf_counter() - t_release:.0f} s)")
        torch.cuda.empty_cache()
        t_programs = time.perf_counter()
        programs_launches, programs_rates = programs_phase_fresh(tmp)
        print(f"[programs] done at {time.perf_counter() - t_start:.0f} s (phase "
              f"{time.perf_counter() - t_programs:.0f} s)")
        t_modes = time.perf_counter()
        modes_launches, modes_rates = modes_phase_fresh(tmp)
        print(f"[modes] done at {time.perf_counter() - t_start:.0f} s (phase "
              f"{time.perf_counter() - t_modes:.0f} s)")
        t_tp = time.perf_counter()
        torch.cuda.empty_cache()  # the fresh process trains at bf16 b128 (~46 GiB)
        print(f"[train-programs] this process holds "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved on the card")
        tp_launches, tp_rates = train_programs_phase_fresh(tmp)
        print(f"[train-programs] done at {time.perf_counter() - t_start:.0f} s (phase "
              f"{time.perf_counter() - t_tp:.0f} s); total run "
              f"{time.perf_counter() - t_start:.0f} s")

    nms = nms_rec[KERNEL_B]
    kernel_lines = [{
        "name": "nms_sweep",
        "route": "cuda",
        "source": "face_vijnana_yolov3_tpu_torch/csrc/nms_sweep.cu",
        "replaces": "face_vijnana_yolov3_tpu/ops/pallas_nms.py:35",
        "launches": launches["nms_sweep"],
        "max_abs_err": max(max_err, coco_rates["max_abs_err"]["nms_sweep"]),
        "ms": nms["ms"],
        "plain_ms": nms["plain_ms"],
        "bound_ms": nms["bound_ms"],
        "bound_by": nms["bound_by"],
        "library_ms": None,
        "launches_identify": fi_launches["nms_sweep"],
        "launches_coco": coco_launches["nms_sweep"],
        "launches_coco_replay": coco_rates["launches_coco_replay"]["nms_sweep"],
        "launches_deploy": deploy_launches["nms_sweep"],
        "launches_deploy_dp_replay": deploy_rates["dp_replay_launches"]["nms_sweep"],
        "launches_release": release_launches["nms_sweep"],
        "launches_programs": programs_launches.get("nms_sweep", 0),
        "launches_modes": modes_launches.get("nms_sweep", 0),
        "launches_train_programs": tp_launches.get("nms_sweep", 0),
        "events_ms": nms["events_ms"],
        "ms_coco_80x256": coco_rates["nms_ms_80x256"],
        "plain_ms_coco_80x256": coco_rates["nms_plain_ms_80x256"],
        "bound_ms_coco_80x256": coco_rates["nms_bound_ms_80x256"],
        f"ms_b{NMS_TIMING_B2}": nms_rec[NMS_TIMING_B2]["ms"],
        **{f"{key}_n{n}_b{NMS_TIMING_B2}": rec[key] for n, rec in nms_large.items()
           for key in ("ms", "events_ms", "plain_ms", "bound_ms")},
    }]
    off = int8_rec["conv_int8 blocks off"]
    for name, src, replaces, rec, n, err in (
            ("conv_int8", "face_vijnana_yolov3_tpu_torch/csrc/conv_int8.cu",
             "face_vijnana_yolov3_tpu/models/quant.py:666", int8_rec["conv_int8"],
             launches["conv_int8"], int8_err["conv_int8"]),
            ("block_int8", "face_vijnana_yolov3_tpu_torch/csrc/block_int8.cu",
             "face_vijnana_yolov3_tpu/ops/pallas_block.py:88", int8_rec["block_int8"],
             launches["block_int8"], int8_err["block_int8"]),
            ("fused_front", "face_vijnana_yolov3_tpu_torch/csrc/front_fused.cu",
             "face_vijnana_yolov3_tpu/ops/pallas_front.py:49", front_rec,
             bf16_launches["fused_front"], front_err)):
        kernel_lines.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": n, "max_abs_err": max(err, coco_rates["max_abs_err"].get(name, 0)),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "launches_identify": fi_launches[name],
            "launches_coco": coco_launches[name],
            "launches_coco_replay": coco_rates["launches_coco_replay"].get(name, 0),
            "launches_deploy": deploy_launches.get(name, 0),
            "launches_deploy_dp_replay": deploy_rates["dp_replay_launches"].get(name, 0),
            "launches_release": release_launches[name],
            "launches_programs": programs_launches.get(name, 0),
            "launches_modes": modes_launches.get(name, 0),
            "launches_train_programs": tp_launches.get(name, 0),
        })
        if name == "fused_front":
            kernel_lines[-1].update(events_ms=rec["events_ms"], stock_front_ms=rec["stock_ms"])
        if name == "conv_int8":  # the default path: the trunk with the blocks off
            kernel_lines[-1].update(
                ms_blocks_off=off["ms"], plain_ms_blocks_off=off["plain_ms"],
                bound_ms_blocks_off=off["bound_ms"],
                library_ms_blocks_off=off["library_ms"])
    print(json.dumps({"train_img_s": {k: {"img_s": v[0], "batch": v[1], "peak_gib": v[2]}
                                      for k, v in train_rates.items()},
                      "trained_serving_launches": train_launches}))
    print(json.dumps({"calib_divisions": calib_rates}))
    print(json.dumps({"identify": fi_rates, "identify_launches": fi_launches}))
    print(json.dumps({"coco": coco_rates, "coco_launches": coco_launches}))
    print(json.dumps({"deploy": deploy_rates, "deploy_launches": deploy_launches}))
    print(json.dumps({"release": release_rates, "release_launches": release_launches}))
    print(json.dumps({"programs": programs_rates, "programs_launches": programs_launches}))
    print(json.dumps({"modes": modes_rates, "modes_launches": modes_launches}))
    print(json.dumps({"train_programs": tp_rates, "train_programs_launches": tp_launches}))
    print(json.dumps({"kernels": kernel_lines}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
