"""Typed configuration reproducing the reference's JSON schema.

A copy of face_vijnana_yolov3_tpu/api/config.py, so that the port imports
nothing of the JAX package; tests/test_torch_config.py holds the two equal
(defaults, `load_conf` and `apply_overrides`). Module paths named in the
comments below are the JAX package's.

Schema source: reference face_vijnana_yolov3.json:1-62 and README.md:67-128 — a
top-level object with `fd_conf` / `fi_conf` sections, each holding mode, paths,
multi-gpu toggles, model-loading flags, `hps` and `nn_arch` sub-dicts. The
reference's docker variant exposes the same knobs as argparse flags
(docker/code/face_detection.py:1140-1154); `apply_overrides` reproduces that
second interface as dotted-path CLI overrides (e.g. `--set hps.lr=1e-3`).

Like the reference, `hps['step']` is a placeholder that the data pipeline
overwrites at runtime with ceil(N / batch_size) (face_detection.py:87-90).
"""

from __future__ import annotations

import dataclasses
import json
import platform
from typing import Any


@dataclasses.dataclass
class FdHps:
    lr: float = 0.0001
    beta_1: float = 0.99
    beta_2: float = 0.99
    decay: float = 0.0
    epochs: int = 6
    step: int = 1
    batch_size: int = 40
    face_conf_th: float = 0.5
    nms_iou_th: float = 0.5
    num_cands: int = 60
    face_region_ratio_th: float = 0.8


@dataclasses.dataclass
class FdNNArch:
    image_size: int = 416
    bb_info_c_size: int = 6


@dataclasses.dataclass
class FdConf:
    mode: str = "train"
    raw_data_path: str = ""
    test_path: str = ""
    output_file_path: str = "solution_fd.csv"
    multi_gpu: bool = False          # reference knob; maps to data-parallel mesh
    num_gpus: int = 4                # ignored on TPU (mesh uses all devices)
    yolov3_base_model_load: bool = False
    model_loading: bool = False
    weights_path: str = "yolov3.weights"
    model_path: str = "face_detector_tpu"
    # Docker-variant behavior toggle: the legacy argparse build applies an
    # aspect-ratio correction with RATIO_TH=face_region_ratio_th
    # (docker/code/face_detection.py:415-422) that src/space comments out.
    apply_face_region_ratio: bool = False
    # Framework extensions (no reference counterpart; defaults = reference
    # behavior): periodic Orbax checkpointing for kill-resume, and host-RAM
    # caching of assembled training samples (multi-epoch runs on a weak host
    # are otherwise JPEG-decode bound).
    checkpoint_every: int = 0
    dataset_cache: str = "none"
    # int8 activation calibration: percentile of |activation| to clip each
    # graph position's range to; 0 = exact maxabs; "auto" (default) scores
    # maxabs vs each clip candidate per channel by measured int8 round-trip
    # MSE and clips only where decisively better (models/quant.py
    # AUTO_CALIB_MARGIN). Any FIXED choice is checkpoint-dependent: one
    # trained artifact collapsed under per-tensor maxabs (AP50 0.80→0.21,
    # p99.99 rescued it), another collapsed under p99.99 (0.86→0.54, maxabs
    # rescued it); auto scores 0.8445 on the latter — above both fixed
    # choices (scripts/probe_precision_ap.py).
    int8_calib_percentile: float | str = "auto"
    # PTQ bias correction: fold each conv's measured per-channel mean
    # quantization error (vs the f32 twin, on the calibration batch) into its
    # deployed bias — zero runtime cost (models/quant.bias_correct_quant).
    # Only useful WITH a fixed clip percentile (it removes the clip's
    # systematic mean shift: p99.99 0.744→0.793, +tail4 0.820→0.848 on the
    # brittle bench artifact); it HURTS maxabs/"auto" grids (correcting
    # calibration-batch rounding noise overfits: auto 0.738→0.459).
    # Ignored when int8_qat_steps > 0 (QAT trains the uncorrected program).
    int8_bias_correct: bool = False
    # Mixed-precision tail: keep the last N trunk residual blocks bf16 in the
    # int8 serving path (0 = full int8). Trained checkpoints' late-layer
    # outliers are the int8 AP gap (models/quant.py bf16_tail_blocks).
    int8_bf16_tail: int = 0
    # Selective bf16 islands: conv indices served folded-bf16 INSIDE the
    # int8 walk (models/quant.quantize_folded bf16_ops) — name the damage
    # layers int8_error_profile localizes instead of paying a whole
    # contiguous tail. Empty = none. Disables the autotail self-check's
    # tail escalation when set (the named set IS the mitigation).
    int8_bf16_ops: tuple = ()
    # Calibration SELF-CHECK (models/quant.quantize_autotail, default on):
    # when int8_bf16_tail is 0 and no QAT, verify the freshly calibrated
    # int8 program against the folded-f32 head on the calibration batch and
    # escalate the bf16 tail (0→2→4→5→6→8) only while escalation decisively
    # improves the detection-level error. int8 PTQ is checkpoint-dependent —
    # the same auto calibration measured AP50 drift -0.02 on one bench
    # checkpoint and -0.34 on another; a silent collapse is worse than the
    # tail's throughput tax. On the round-4 bench checkpoint the ladder
    # lands on tail5 (= f32 AP at 3699 img/s b1024; quantize_autotail
    # docstring has the measured frontier). Costs one extra forward on
    # healthy checkpoints.
    int8_tail_auto: bool = True
    # Quantization-aware training (darknet.apply_graph fakequant): the train
    # forward carries int8 fake-quant noise (STE) at the serving requant
    # positions, so the resulting checkpoint's PTQ int8 path needs little or
    # no bf16 tail. Off by default — reference parity trains plain f32
    # (src/space/face_detection.py:381); the bench recipe turns it on.
    train_qat: bool = False
    # bf16 serving: run the first N trunk segments (1 = conv_0/1, 2 = + first
    # residual block) in f32. Trained checkpoints amplify bf16 input rounding
    # in exactly those layers on rare images (degenerate ~1.0-score boxes,
    # AP50 0.79->0.45 on the bench checkpoint); N=2 restores AP50 to 0.783
    # at ~30% bf16 throughput cost — bf16 is the no-calibration fallback,
    # accuracy wins; int8 (the headline path) is unaffected
    # (scripts/probe_bf16_degen.py, models/darknet.py).
    # "auto": probe the LOADED checkpoint on the first detect batch and keep
    # the shallowest depth {0,1,2} whose bf16 head reproduces the f32
    # detections (box-F1 self-check, same machinery as int8 autotail) —
    # reclaims the ~26% guard tax on checkpoints that don't need it
    # (FaceDetectorPipeline.autoselect_bf16_front; depth 2 is the fallback).
    bf16_f32_front: int | str = 2
    # bf16 front-guard flavor — EXPERIMENTAL, measured HARMFUL; keep "f32".
    # "int8" swaps the f32 guard for a calibrated int8 front (quant.py with
    # bf16_tail_blocks = everything after the guard; auto-calibrates on the
    # first detect batch like precision="int8"). Hypothesis was guard-level
    # accuracy at ~unguarded speed (the full-int8 path resists the input
    # noise that breaks raw bf16, AP50 0.8018 vs 0.4548). Measured on the
    # bench checkpoint it COLLAPSES instead: AP50 0.0957 (front 1) / 0.1731
    # (front 2) vs 0.7833 for the f32 guard — int8's ABSOLUTE grid noise in
    # the brittle front (15% more obj-threshold crossings) is faithfully
    # amplified by the bf16 tail, whereas in full int8 the downstream
    # requant grids absorb it. Kept for diagnosis only (PROFILE.md).
    bf16_front_mode: str = "f32"
    # Distillation QAT (models/qat.py): N optimizer steps refining the folded
    # kernels so the int8 program reproduces the f32 teacher's head outputs
    # on the calibration images. 0 = plain PTQ. Closes the residual int8 mAP
    # gap at FULL int8 speed (the bf16 tail costs throughput instead); runs
    # once inside calibrate_int8, label-free.
    int8_qat_steps: int = 0
    int8_qat_lr: float = 1e-5
    # Train only the convs of the last N residual blocks during QAT (0 = all).
    # Full-graph distillation demonstrably HURTS on trained checkpoints (AP50
    # 0.80 -> 0.36, scripts/probe_qat.py): near the PTQ noise floor STE
    # gradients random-walk the perturbation-brittle front convs, while the
    # int8 gap itself lives in the late blocks (the bf16-tail evidence).
    int8_qat_tail: int = 4
    # int8 serving: run the 20 lane-aligned trunk residual blocks (stages
    # 3/4/5) as fused Pallas kernels — the 1x1 intermediate stays in VMEM and
    # the 3x3 runs as 9 MXU tap matmuls (ops/pallas_block.py). Bit-exact vs
    # the stock XLA path (tests/test_pallas_block.py) but measured SLOWER on
    # a real v5e (1.2-1.9x per stage; XLA's int8 conv emitter already runs
    # ~73% of MXU peak on these shapes — table in ops/pallas_block.py and
    # PROFILE.md). Kept off; the knob remains for future Mosaic versions.
    int8_pallas_blocks: bool = False
    hps: FdHps = dataclasses.field(default_factory=FdHps)
    nn_arch: FdNNArch = dataclasses.field(default_factory=FdNNArch)


@dataclasses.dataclass
class FiHps:
    lr: float = 0.001
    beta_1: float = 0.99
    beta_2: float = 0.99
    decay: float = 0.0
    epochs: int = 1
    step: int = 1
    batch_size: int = 1
    sim_th: float = 0.2
    face_conf_th: float = 0.5


@dataclasses.dataclass
class FiNNArch:
    image_size: int = 416
    dense1_dim: int = 64


@dataclasses.dataclass
class FiConf:
    mode: str = "train"
    resource_type: str = "uccs"      # 'uccs' | 'vggface2'
    raw_data_path: str = ""
    test_path: str = ""
    output_file_path: str = "solution_fi.csv"
    multi_gpu: bool = False
    num_gpus: int = 4
    yolov3_base_model_load: bool = False
    face_vijana_recon_load: bool = False  # reference spelling preserved
    model_loading: bool = False
    weights_path: str = "yolov3.weights"
    model_path: str = "face_identifier_tpu"
    # Framework extensions, as in FdConf. model_axis > 1 turns on tensor
    # parallelism for dense1 (the 173056-wide flatten matmul, the reference's
    # biggest single tensor): devices arrange as a
    # (data = n/model_axis, model = model_axis) mesh.
    model_axis: int = 1
    # "random" = reference-faithful uniform-random negatives; "semi_hard" =
    # in-batch FaceNet semi-hard re-selection inside the jitted step.
    negative_mining: str = "random"
    checkpoint_every: int = 0
    # Triplet-step remat granularity (train/trainer.train_identifier): False
    # = no rematerialization (the default — fastest), int N = checkpoint only
    # the first N trunk segments, True = every residual block (lowest HBM).
    # Measured on one v5e at 416² bf16 (PROFILE.md identifier section): the
    # 3x-stacked batch fits HBM without remat through b64 (192 images) and
    # remat-off wins ~24% (b32: 207 vs 167 triplets/s). Set True (or N) only
    # if a larger batch/resolution OOMs.
    train_remat: bool | int = False
    # Quantization-aware training of the shared trunk (see FdConf.train_qat):
    # the lever for an int8-eligible FI embed path — PTQ int8 on a
    # plain-trained identifier measured a 7.2% registry-match flip rate
    # (over the 5% export gate; scripts/probe_fi_int8_acc.py).
    train_qat: bool = False
    # Same semantics as FdConf.int8_calib_percentile ("auto" = per-channel
    # measured-MSE choice between maxabs and clip candidates).
    int8_calib_percentile: float | str = "auto"
    # Same semantics as FdConf.int8_bias_correct.
    int8_bias_correct: bool = False
    # Same trunk f32-front guard as FdConf.bf16_f32_front, for the bf16
    # folded embed path (models/identifier.embed_folded).
    bf16_f32_front: int = 2
    # Guard flavor, as FdConf.bf16_front_mode: "int8" swaps the f32 front for
    # a calibrated int8 front (auto-calibrated on the first embed batch).
    # EXPERIMENTAL — measured harmful on the detector twin (see FdConf);
    # keep "f32".
    bf16_front_mode: str = "f32"
    # Device-fused identification serving (ops/roi.py): per-box crop +
    # cv2-exact cubic letterbox run as MXU matmuls against the staged
    # original image, fused with embed + registry match in one program —
    # host work per box drops from a single-core cv2 cubic resize + f32
    # crop upload to a ~13 KB tap table. Float-rounding-level parity with
    # the host path (reference math is f64, this is f32 HIGHEST); default
    # off = bit-faithful host crops. Env FVY_DEVICE_ROI=1 also enables.
    device_roi: bool = False
    hps: FiHps = dataclasses.field(default_factory=FiHps)
    nn_arch: FiNNArch = dataclasses.field(default_factory=FiNNArch)


@dataclasses.dataclass
class Conf:
    fd_conf: FdConf = dataclasses.field(default_factory=FdConf)
    fi_conf: FiConf = dataclasses.field(default_factory=FiConf)


def _merge_dataclass(dc, data: dict):
    for field in dataclasses.fields(dc):
        if field.name not in data:
            continue
        value = data[field.name]
        current = getattr(dc, field.name)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _merge_dataclass(current, value)
        else:
            setattr(dc, field.name, value)
    return dc


def load_conf(path: str | None = None, data: dict | None = None) -> Conf:
    """Load from a reference-format JSON file (or an already-parsed dict).

    When `path` is None, falls back to `face_vijnana_yolov3.json` /
    `face_vijnana_yolov3_win.json` by platform, like the reference mains
    (face_detection.py:955-960).
    """
    if data is None:
        if path is None:
            path = (
                "face_vijnana_yolov3_win.json"
                if platform.system() == "Windows"
                else "face_vijnana_yolov3.json"
            )
        with open(path, "r") as f:
            data = json.load(f)
    conf = Conf()
    if "fd_conf" in data:
        _merge_dataclass(conf.fd_conf, data["fd_conf"])
    if "fi_conf" in data:
        _merge_dataclass(conf.fi_conf, data["fi_conf"])
    return conf


def apply_overrides(conf: Conf, overrides: list[str]) -> Conf:
    """Apply `section.path=value` CLI overrides (docker argparse-flag parity).

    Example: ["fd_conf.mode=evaluate", "fd_conf.hps.lr=1e-3"].
    Values parse as JSON when possible, else stay strings.
    """
    for item in overrides:
        path, _, raw = item.partition("=")
        try:
            value: Any = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        node: Any = conf
        parts = path.split(".")
        for p in parts[:-1]:
            node = getattr(node, p)
        if not hasattr(node, parts[-1]):
            raise KeyError(f"unknown config key: {path}")
        setattr(node, parts[-1], value)
    return conf


def conf_to_dict(conf: Conf) -> dict:
    return dataclasses.asdict(conf)
