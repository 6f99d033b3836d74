"""Face detection entry point: train / evaluate / test, config-JSON driven.

Port of face_vijnana_yolov3_tpu/api/face_detection.py (FaceDetectorPipeline,
`main`): detector training (`train`, `fd_conf.mode=train`: f32, bf16 mixed
precision, fake-quant QAT; train/trainer.py) and f32, bf16 and int8 serving
with the same `solution_fd.csv` rows `file,x,y,w,h,score` (at most 60
per image), annotated JPEGs in `<test_path>/results/` and `ratios.csv` in
evaluate mode. Everything runs on the CUDA card unless the caller passes
`device="cpu"`; without a card the default raises.

    python -m face_vijnana_yolov3_tpu_torch.api.face_detection --conf=CONF.json \
        [fd_conf.mode=train|evaluate|test] [--set fd_conf.hps.batch_size=8]

Each batch runs letterbox (host cv2, or the two-matmul device letterbox of
`detect_batch_fused`), the trunk and head (models/detector.py) and the
batched postprocess whose NMS sweep is the CUDA kernel of csrc/nms_sweep.cu.
`precision="int8"` calibrates on the first batch (`calibrate_int8`: fold,
per-channel scales, the box-F1 self-check over bf16 tails, or the tail
pinned in the checkpoint's trainmeta sidecar) and then serves the int8
trunk (csrc/conv_int8.cu; with `int8_pallas_blocks`, the residual blocks of
stages 3-5 through csrc/block_int8.cu) with a bf16 head.
`precision="bfloat16"` serves the folded bf16 trunk and head with the first
`conf.bf16_f32_front` graph segments in f32 (0, 1, 2, or "auto": the
shallowest depth whose detections match the folded f32 head's, probed on
the first batch by `autoselect_bf16_front`). Like the JAX pipeline, it
serves the stock front; the fused front kernel (ops/front_fused.py) is
reached through `apply_graph_folded_front`.

Weights: a `.pt` checkpoint (model_loading), the reference's Keras h5
(`model_path` ending in .h5/.hd5, core/keras_import.py), the cached trunk
`yolov3_base.h5` (yolov3_base_model_load), darknet `yolov3.weights` (then
cached as yolov3_base.h5, as the reference does), or a seeded random trunk.
With `FVY_DEVICE_LETTERBOX=1`, JPEGs decode through the native batched
loader (data/native_loader.py, libjpeg) straight into the uint8 staging
buffer when it builds, else through PIL; `FVY_JPEG_SCALED_DECODE=1` decodes
at a reduced DCT scale (test mode: not bit-exact with a full decode).

Not carried: the legacy `--mode` argparse CLI (ROADMAP.md queue 1 item
10); distillation QAT (`int8_qat_steps`) and `bf16_front_mode="int8"`, both
measured harmful in the JAX package (ROADMAP.md, code the port should not
carry). Deliberate divergence: eager PyTorch has no
per-shape compile to amortise, so `detect_batch_fused` does not pad staged
buffers to 128-multiples or chunks to a fixed batch as the JAX jit does;
results are unchanged by that padding.
"""

from __future__ import annotations

import glob
import os
import shutil
import sys
import time

import numpy as np
import torch

from face_vijnana_yolov3_tpu_torch.api.config import (
    FdConf,
    apply_overrides,
    load_conf,
)
from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
from face_vijnana_yolov3_tpu_torch.core.checkpoints import (
    KERAS_SUFFIXES,
    load_checkpoint,
    load_opt_state,
    load_train_meta,
)
from face_vijnana_yolov3_tpu_torch.data.pipeline import prefetch_batches
from face_vijnana_yolov3_tpu_torch.models import quant
from face_vijnana_yolov3_tpu_torch.models.detector import (
    FaceDetectorModel,
    init_head_params,
)
from face_vijnana_yolov3_tpu_torch.ops.letterbox import (
    letterbox_geometry,
    letterbox_host,
    unletterbox_boxes_chunk,
)
from face_vijnana_yolov3_tpu_torch.ops.postprocess import (
    FacePostprocessConfig,
    face_postprocess_batch,
)
from face_vijnana_yolov3_tpu_torch.ops.resize import (
    letterbox_device_matmul,
    letterbox_matrices,
)
from face_vijnana_yolov3_tpu_torch.utils.io import imread, imsave

DEBUG = True


def resolve_device(device: torch.device | str | None) -> torch.device:
    """`device`, or the CUDA card when None; a CUDA device without a card
    raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the port serves on the card by "
            "default; pass device='cpu' to run on the CPU")
    return dev


class FaceDetectorPipeline:
    """Detector lifecycle: build/load weights, batched detect, modes."""

    def __init__(self, conf: FdConf, *, precision: str = "float32",
                 device: torch.device | str | None = None):
        if getattr(conf, "bf16_front_mode", "f32") == "int8":
            raise NotImplementedError(
                "bf16_front_mode='int8' is not carried into the port: it "
                "collapses AP50 in the JAX package (ROADMAP.md, code the "
                "port should not carry)")
        if precision == "int8":
            if getattr(conf, "int8_qat_steps", 0):
                raise NotImplementedError(
                    "int8_qat_steps > 0: distillation QAT is not carried into "
                    "the port: it measured below every PTQ row in the JAX "
                    "package (ROADMAP.md, code the port should not carry)")
        elif precision not in ("float32", "bfloat16"):
            raise NotImplementedError(
                f"precision={precision!r}: the port serves float32, bfloat16 "
                "and int8, the JAX package's serving precisions (ROADMAP.md "
                "queue 1)")
        self.device = resolve_device(device)
        # The f32 contract (JAX Precision.HIGHEST): cuDNN convs default to
        # TF32 on the card, which keeps about three decimal digits.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.conf = conf
        self.hps = vars(conf.hps) if not isinstance(conf.hps, dict) else conf.hps
        self.nn_arch = (
            vars(conf.nn_arch) if not isinstance(conf.nn_arch, dict) else conf.nn_arch
        )
        self.image_size = self.nn_arch["image_size"]
        self.grid = self.image_size // 32  # 13 at the reference's 416
        self.precision = precision
        self.model = FaceDetectorModel(
            image_size=self.image_size,
            out_channels=self.nn_arch["bb_info_c_size"],
            device=self.device,
        )
        # The trainmeta sidecar: a QAT checkpoint, and the int8 serving tail
        # measured at release time (None = no pin).
        self._ckpt_qat = False
        self._ckpt_int8_tail = None
        self.opt_state = None  # Adam state of a resumed training run
        if conf.model_loading:
            sd = load_checkpoint(conf.model_path)
            if not conf.model_path.endswith(KERAS_SUFFIXES):
                self.opt_state = load_opt_state(conf.model_path)
                tm = load_train_meta(conf.model_path)
                self._ckpt_qat = bool(tm.get("qat", False))
                self._ckpt_int8_tail = tm.get("int8_tail")
        elif conf.yolov3_base_model_load and os.path.exists("yolov3_base.h5"):
            # The reference's cached trunk (face_detection.py:393-396), a
            # fresh head.
            from face_vijnana_yolov3_tpu_torch.core.keras_import import (
                collect_keras_weights,
                trunk_from_keras,
            )

            sd = trunk_from_keras(collect_keras_weights("yolov3_base.h5"))
            sd.update(params_from_jax(
                {"head": init_head_params(1, self.model.out_channels)}, {}))
        elif os.path.exists(conf.weights_path):
            sd = self.model.init_from_darknet(conf.weights_path, seed=0)
            # As the reference: cache the built trunk so the next run with
            # yolov3_base_model_load skips the darknet parse.
            from face_vijnana_yolov3_tpu_torch.core.keras_import import (
                save_trunk_keras_h5,
            )

            save_trunk_keras_h5(sd, "yolov3_base.h5")
        else:
            # The reference hard-requires yolov3.weights; a fresh random trunk
            # keeps the pipeline runnable in weightless environments (tests).
            print(
                f"[face_detection] {conf.weights_path} not found — "
                "random-initializing trunk"
            )
            sd = params_from_jax(*self.model.init_params(0))
        self.model.load_state_dict(sd)
        self.model.eval()

        self._pp_cfg = FacePostprocessConfig(
            image_size=self.image_size,
            grid=self.grid,
            conf_th=self.hps["face_conf_th"],
            nms_iou_th=self.hps["nms_iou_th"],
            num_cands=self.hps["num_cands"],
        )
        self._mat_cache: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
        self._qparams: dict | None = None
        self._folded: dict | None = None  # bf16: folded once, on first use

    # -------------------------------------------------------------- int8

    @torch.inference_mode()
    def calibrate_int8(self, images, percentile=None):
        """Calibrate int8 serving on a representative letterboxed batch
        (api/face_detection.py:153-289 of the JAX package).

        Folds conv+BN, calibrates per-channel scales on the first 16 images
        and quantizes the weights (models/quant.py). Unless
        conf.int8_bf16_tail or conf.int8_bf16_ops fix the configuration (or
        conf.int8_tail_auto is off), the serving tail is chosen strongest
        evidence first: the checkpoint's measured `int8_tail` pin, else full
        int8 for a QAT checkpoint, else the ladder (0, 2, 4, 5, 6, 8) scored
        by the box-F1 self-check on up to 32 images. detect_batch and
        detect_batch_fused call this on their first batch.
        """
        if percentile is None:
            percentile = getattr(self.conf, "int8_calib_percentile", 0.0) or None
        folded = self.model.fold()
        x = torch.as_tensor(np.asarray(images) if not isinstance(images, torch.Tensor)
                            else images, dtype=torch.float32, device=self.device)
        tail_cfg = getattr(self.conf, "int8_bf16_tail", 0)
        bf16_ops = tuple(getattr(self.conf, "int8_bf16_ops", ()) or ())
        if not tail_cfg and not bf16_ops and getattr(self.conf, "int8_tail_auto", True):
            if self._ckpt_int8_tail is not None:
                tails = (int(self._ckpt_int8_tail),)
            elif self._ckpt_qat:
                tails = (0,)
            else:
                tails = (0, 2, 4, 5, 6, 8)
            q, tail, err = quant.quantize_autotail(
                self.model, folded, x[:32], percentile=percentile, tails=tails,
                bias_correct=bool(getattr(self.conf, "int8_bias_correct", False)),
                scorer=quant.detection_box_f1_scorer(self._pp_cfg, self.device))
            self._qparams = quant.to_device(q, self.device)
            self.int8_tail_chosen = tail
            self.int8_calib_err = err
            if tail:
                print(f"[calibrate_int8] self-check 1-boxF1 {err:.4f} over "
                      f"threshold — serving with bf16 tail {tail}")
            return
        # Bias correction is off after distillation QAT (not carried here) and
        # with bf16 islands (its walk models an all-int8 program), as in the
        # JAX package.
        bias_correct = (not getattr(self.conf, "int8_qat_steps", 0) and not bf16_ops
                        and bool(getattr(self.conf, "int8_bias_correct", False)))
        self._qparams = quant.to_device(
            self.model.quantize(folded, x[:16], percentile=percentile,
                                bf16_tail_blocks=tail_cfg, bf16_ops=bf16_ops,
                                bias_correct=bias_correct),
            self.device)
        self.int8_tail_chosen = tail_cfg

    # -------------------------------------------------------------- bf16

    def _folded_params(self) -> dict:
        if self._folded is None:
            self._folded = self.model.fold()
        return self._folded

    def _bf16_front_depth(self) -> int:
        """Resolve conf.bf16_f32_front: an int is used as-is; "auto" reads
        the depth autoselect_bf16_front measured (2, the conservative
        default, until the probe has run)."""
        front = getattr(self.conf, "bf16_f32_front", 2)
        if front == "auto":
            return int(getattr(self, "bf16_front_chosen", 2))
        return int(front)

    def _bf16_head(self, images: torch.Tensor, depth: int) -> torch.Tensor:
        """The bf16 serving program's head at f32-front guard `depth`: what
        `_detect` serves and what `autoselect_bf16_front` scores."""
        return self.model.apply_folded(self._folded_params(), images,
                                       compute_dtype=torch.bfloat16,
                                       f32_front_blocks=depth)

    @torch.inference_mode()
    def autoselect_bf16_front(self, images, threshold: float = 0.05):
        """Pick the shallowest f32-front guard depth in {0, 1, 2} whose bf16
        head reproduces the f32 detections on a representative batch
        (api/face_detection.py:308-392 of the JAX package).

        Depths escalate 0 → 1 → 2 until the box-F1 error
        (quant.detection_box_f1_scorer) of the bf16 head against the folded
        f32 head on the first 32 of `images` (letterboxed, (N, S, S, 3))
        passes `threshold`; depth 2 is the fallback when none does. Returns
        (depth, err) and pins the choice (`bf16_front_chosen`) for
        conf.bf16_f32_front == "auto".

        The probe defers (depth 2 served, nothing pinned, a later batch
        probes again) when the batch has fewer than 16 images, or when the
        scorer is inconclusive (the f32 reference detects nothing, so its
        NRMSE fallback would pass vacuously); after 3 inconclusive probes
        depth 2 is pinned. Each candidate runs `_bf16_head`, the very
        function `_detect` serves (the JAX lesson: probe the exact serving
        program).
        """
        if images.shape[0] < 16:
            return 2, None
        x = torch.as_tensor(np.asarray(images) if not isinstance(images, torch.Tensor)
                            else images, dtype=torch.float32,
                            device=self.device)[:32]
        ref = self.model.apply_folded(self._folded_params(), x,
                                      compute_dtype=torch.float32).cpu().numpy()
        scorer = quant.detection_box_f1_scorer(self._pp_cfg, self.device)
        depth, err = 2, None
        inconclusive = False
        for cand in (0, 1, 2):
            err = scorer(ref, self._bf16_head(x, cand).cpu().numpy())
            inconclusive = bool(getattr(scorer, "inconclusive", False))
            if inconclusive:
                break
            if err <= threshold:
                depth = cand
                break
        if inconclusive:
            self._bf16_probe_attempts = getattr(self, "_bf16_probe_attempts", 0) + 1
            if self._bf16_probe_attempts < 3:
                return 2, None
            depth = 2
        self.bf16_front_chosen = depth
        self.bf16_front_err = err
        if depth != 2:
            print(f"[autoselect_bf16_front] guard narrowed to depth {depth} "
                  f"(1-boxF1 {err:.4f} on {x.shape[0]} images)")
        return depth, err

    def _bf16_front_auto_pending(self) -> bool:
        return (self.precision == "bfloat16"
                and getattr(self.conf, "bf16_f32_front", 2) == "auto"
                and not hasattr(self, "bf16_front_chosen"))

    # -------------------------------------------------------------- detect

    @torch.inference_mode()
    def _detect(self, images: torch.Tensor):
        """(B, S, S, 3) f32 on the device → (cands, counts) on the device."""
        if self.precision == "int8":
            if self._qparams is None:
                raise RuntimeError(
                    "int8 precision requires calibrate_int8() before detect")
            head = self.model.apply_quant(
                self._qparams, images,
                fused_blocks=bool(getattr(self.conf, "int8_pallas_blocks", False)))
        elif self.precision == "bfloat16":
            head = self._bf16_head(images, self._bf16_front_depth())
        else:
            head = self.model(images)
        return face_postprocess_batch(head, self._pp_cfg)

    def detect_batch(self, images):
        """(B,S,S,3) letterboxed float images (numpy, or a tensor) →
        (cands (B, num_cands, 6), counts (B,)) as numpy: forward, decode,
        NMS and ascending-score candidate selection, on the device."""
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if self.precision == "int8" and self._qparams is None:
            self.calibrate_int8(x)
        if self._bf16_front_auto_pending():
            self.autoselect_bf16_front(x)
        cands, counts = self._detect(x)
        return cands.cpu().numpy(), counts.cpu().numpy()

    def detect(self, image: np.ndarray):
        """Single-image detect returning box dict rows (reference API shape)."""
        cands, counts = self.detect_batch(image[None] if image.ndim == 3 else image)
        out = []
        for k in range(int(counts[0])):
            x0, y0, x1, y1, obj, score = cands[0, k]
            out.append(
                {"xmin": float(x0), "ymin": float(y0), "xmax": float(x1),
                 "ymax": float(y1), "objness": float(obj), "score": float(score)}
            )
        return out

    # -------------------------------------------------------------- train

    def train(self):
        """Train the detector on `conf.raw_data_path`'s training.csv
        (api/face_detection.py:488-541 of the JAX package) on this
        pipeline's device; returns the per-step losses.

        precision "bfloat16" trains in mixed precision (bf16 convs, f32 BN
        statistics, loss, master params and Adam); "float32" and "int8"
        train in f32 (int8 is a serving mode). conf.train_qat trains with
        int8 fake-quant, conf.checkpoint_every saves every N epochs,
        conf.dataset_cache is DetectionDataset's cache. A Keras-style
        model_path (.h5/.hd5, the reference's face_detector.h5) trains
        against a sibling `<model_path>.pt` and exports the h5 at the end.
        The folded and int8 programs of the old weights are dropped.
        """
        from face_vijnana_yolov3_tpu_torch.data.uccs import DetectionDataset
        from face_vijnana_yolov3_tpu_torch.models.darknet import split_state_dict
        from face_vijnana_yolov3_tpu_torch.train.trainer import train_detector

        dataset = DetectionDataset(
            self.conf.raw_data_path,
            image_size=self.image_size,
            grid=self.grid,
            channels=self.nn_arch["bb_info_c_size"],
            cache=getattr(self.conf, "dataset_cache", "none"),
        )
        keras_h5 = self.conf.model_path.endswith(KERAS_SUFFIXES)
        ckpt_path = (self.conf.model_path + ".pt" if keras_h5
                     else self.conf.model_path)
        params, state = split_state_dict(
            {k: v.detach().clone() for k, v in self.model.state_dict().items()})
        params, state, losses = train_detector(
            self.model, params, state, dataset, self.hps,
            checkpoint_path=ckpt_path,
            init_opt_state=self.opt_state,
            history_path=ckpt_path + "_history.jsonl",
            compute_dtype=(torch.bfloat16 if self.precision == "bfloat16"
                           else None),
            checkpoint_every=getattr(self.conf, "checkpoint_every", 0),
            fakequant=getattr(self.conf, "train_qat", False),
        )
        self.model.load_state_dict({**params, **state})
        print("Save the model.")
        if keras_h5:
            from face_vijnana_yolov3_tpu_torch.core.keras_import import (
                save_detector_keras_h5,
            )

            save_detector_keras_h5(self.model.state_dict(), self.conf.model_path)
        # New weights: every folded or calibrated program is stale (an int8
        # detect recalibrates on its next batch).
        self._folded = None
        self._qparams = None
        return losses

    # -------------------------------------------------------------- evaluate/test

    def _matrices(self, g, max_h: int, max_w: int, dec=None):
        dh, dw = (int(dec[0]), int(dec[1])) if dec is not None else (None, None)
        key = (g.src_h, g.src_w, max_h, max_w, dh, dw)
        if key not in self._mat_cache:
            row, col = letterbox_matrices(g, max_h, max_w, self.image_size,
                                          dec_h=dh, dec_w=dw)
            self._mat_cache[key] = (torch.from_numpy(row).to(self.device),
                                    torch.from_numpy(col).to(self.device))
        return self._mat_cache[key]

    def detect_batch_fused(self, staged, geoms: list, dec_dims=None):
        """Strict letterbox + detect, entirely on the device.

        `staged` is (B, maxH, maxW, 3) images packed top-left — uint8 raw
        pixels (normalised on the device as `* (1/255)`, the JAX fused
        path's order) or float32 already /255 — as numpy or a tensor.
        `geoms` the per-image LetterboxGeometry list. The cv2-faithful cubic
        resize runs as two f32 matmuls; a batch of one geometry broadcasts
        one matrix pair. dec_dims: (B, 2) staged pixel dims when the JPEGs
        were decoded at a reduced DCT scale (native_loader.
        decode_batch_staged_scaled); the geoms stay in original coordinates.
        """
        n = staged.shape[0]
        if n == 0:
            return (np.zeros((0, self.hps["num_cands"], 6), np.float32),
                    np.zeros((0,), np.int32))
        max_h, max_w = int(staged.shape[1]), int(staged.shape[2])
        decs = [None] * n if dec_dims is None else list(dec_dims)
        mats = [self._matrices(g, max_h, max_w, d) for g, d in zip(geoms, decs)]
        if all(m is mats[0] for m in mats):
            row_ms, col_ms = mats[0][0][None], mats[0][1][None]
        else:
            row_ms = torch.stack([m[0] for m in mats])
            col_ms = torch.stack([m[1] for m in mats])
        s = torch.as_tensor(staged, device=self.device)
        s = (s.to(torch.float32) * (1.0 / 255.0) if s.dtype == torch.uint8
             else s.to(torch.float32))
        need_calib = self.precision == "int8" and self._qparams is None
        need_front = self._bf16_front_auto_pending()
        if need_calib or need_front:
            # Up to 32 images: the box-F1 self-check needs at least 16 to
            # resolve tail improvements (quantize_autotail).
            k = min(32, n)
            with torch.inference_mode():
                lb = letterbox_device_matmul(s[:k], row_ms[:k], col_ms[:k])
            if need_calib:
                self.calibrate_int8(lb)
            if need_front:
                self.autoselect_bf16_front(lb)
        with torch.inference_mode():
            lb = letterbox_device_matmul(s, row_ms, col_ms)
        cands, counts = self._detect(lb)
        return cands.cpu().numpy(), counts.cpu().numpy()

    def _iter_detection_chunks(self, file_names: list[str], batch_size: int,
                               device_letterbox: bool | None = None,
                               scaled_decode: bool | None = None):
        """Letterbox + detect in device batches; yields per-CHUNK results
        (chunk_files, originals, geoms, boxes_list), boxes_list[k] rows being
        [xmin, ymin, xmax, ymax, score] floats in original coords.

        device_letterbox=True routes preprocessing through
        `detect_batch_fused` (default: env FVY_DEVICE_LETTERBOX=1); its JPEGs
        then decode through the native batched loader (data/native_loader)
        straight into the uint8 staging buffer when the library builds, else
        through PIL. scaled_decode=True (default: env
        FVY_JPEG_SCALED_DECODE=1; native device-letterbox path only) decodes
        at the smallest DCT scale M/8 that still covers the letterbox: the
        yielded originals are then the scaled pixels (no overlays on this
        path), the geometry and box coordinates stay the true ones. The
        prefetch thread decodes the next chunk and starts its upload while
        the device works on the current one.
        """
        if device_letterbox is None:
            device_letterbox = os.environ.get("FVY_DEVICE_LETTERBOX") == "1"
        if scaled_decode is None:
            scaled_decode = os.environ.get("FVY_JPEG_SCALED_DECODE") == "1"
        native = None
        if device_letterbox:
            from face_vijnana_yolov3_tpu_torch.data import native_loader

            if native_loader.native_available() and all(
                fn.lower().endswith((".jpg", ".jpeg")) for fn in file_names
            ):
                native = native_loader
        self.jpeg_decoder = "native" if native is not None else "PIL"
        chunks = [
            file_names[s : s + batch_size]
            for s in range(0, len(file_names), batch_size)
        ]

        def load_chunk(i):
            chunk = chunks[i]
            if native is not None and scaled_decode:
                staged, dec_dims, orig_dims = native.decode_batch_staged_scaled(
                    chunk, self.image_size)
                originals = [staged[k, : dec_dims[k, 0], : dec_dims[k, 1]]
                             for k in range(len(chunk))]
                geoms = [letterbox_geometry(int(d[0]), int(d[1]), self.image_size)
                         for d in orig_dims]
                return ("staged", torch.from_numpy(staged), geoms, originals, dec_dims)
            if native is not None:
                staged, dims = native.decode_batch_staged(chunk)
                originals = [staged[k, : dims[k, 0], : dims[k, 1]]
                             for k in range(len(chunk))]
                geoms = [letterbox_geometry(int(d[0]), int(d[1]), self.image_size)
                         for d in dims]
                return ("staged", torch.from_numpy(staged), geoms, originals, None)
            originals = [imread(fn) for fn in chunk]
            geoms = [
                letterbox_geometry(im.shape[0], im.shape[1], self.image_size)
                for im in originals
            ]
            if device_letterbox:
                max_h = max(im.shape[0] for im in originals)
                max_w = max(im.shape[1] for im in originals)
                staged = np.zeros((len(chunk), max_h, max_w, 3), np.uint8)
                for k, im in enumerate(originals):
                    staged[k, : im.shape[0], : im.shape[1]] = im
                return ("staged", torch.from_numpy(staged), geoms, originals, None)
            images = np.asarray(
                [letterbox_host(im / 255, self.image_size, "cubic")[0]
                 for im in originals],
                np.float32,
            )
            return ("letterboxed", torch.from_numpy(images), geoms, originals, None)

        loaded = prefetch_batches(
            load_chunk, len(chunks), prefetch=2, device=self.device
        )
        for chunk, (kind, batch, geoms, originals, dec_dims) in zip(chunks, loaded):
            if kind == "staged":
                cands, counts = self.detect_batch_fused(batch, geoms, dec_dims=dec_dims)
            else:
                cands, counts = self.detect_batch(batch)
            ub = unletterbox_boxes_chunk(cands, geoms)
            scores = cands[..., 5].astype(np.float64)
            boxes_list = []
            for k in range(len(chunk)):
                n = int(counts[k])
                boxes = ub[k, :n]
                if self.conf.apply_face_region_ratio:
                    boxes = self._correct_aspect_ratio(boxes)
                boxes_list.append(
                    np.concatenate([boxes, scores[k, :n, None]], axis=1)
                )
            yield chunk, originals, geoms, boxes_list

    def _iter_detections(self, file_names: list[str], batch_size: int,
                         device_letterbox: bool | None = None):
        """Per-image view of `_iter_detection_chunks`: yields
        (file_name, original_image, geom, boxes)."""
        for chunk, originals, geoms, boxes_list in self._iter_detection_chunks(
            file_names, batch_size, device_letterbox=device_letterbox,
        ):
            for k, fn in enumerate(chunk):
                yield fn, originals[k], geoms[k], boxes_list[k]

    def _correct_aspect_ratio(self, boxes: np.ndarray) -> np.ndarray:
        """Docker-variant aspect correction: widen the short axis up to
        face_region_ratio_th."""
        th = self.hps["face_region_ratio_th"]
        out = boxes.copy()
        for r in out:
            w = r[2] - r[0]
            h = r[3] - r[1]
            if h <= 0 or w <= 0:
                continue
            if w / h < th:
                r[2] = th * h + r[0]
            elif h / w < th:
                r[3] = th * w + r[1]
        return out

    def _write_rows(self, f, file_name: str, boxes: np.ndarray):
        """≤60 CSV rows `file,x,y,w,h,score`."""
        count = 1
        base = file_name.split(os.sep)[-1]
        for row in boxes:
            if count > 60:
                break
            xmin, ymin, xmax, ymax, score = row
            f.write(
                f"{base},{xmin},{ymin},{xmax - xmin},{ymax - ymin},{score}\n"
            )
            count += 1

    def evaluate(self):
        import pandas as pd

        from face_vijnana_yolov3_tpu_torch.utils.drawing import draw_boxes

        test_path = self.conf.test_path
        output_file_path = self.conf.output_file_path
        results_dir = os.path.join(test_path, "results")
        if os.path.isdir(results_dir):
            shutil.rmtree(results_dir)
        os.mkdir(results_dir)

        gt_df = pd.read_csv(os.path.join(test_path, "validation.csv"))
        gt_groups = gt_df.groupby("FILE")
        file_names = glob.glob(os.path.join(test_path, "*.jpg"))
        ratios = []

        count1 = 1
        with open(output_file_path, "w") as f:
            for fn, image_o, _geom, boxes in self._iter_detections(
                file_names, int(self.hps["batch_size"])
            ):
                if DEBUG:
                    print(count1, "/", len(file_names), fn)
                count1 += 1
                self._write_rows(f, fn, boxes)
                if boxes.shape[0] == 0:
                    continue

                base = fn.split(os.sep)[-1]
                try:
                    df = gt_groups.get_group(base)
                except KeyError:
                    # As in the JAX package: an image absent from
                    # validation.csv keeps its CSV rows, only the GT overlay
                    # is skipped.
                    continue
                gt_boxes = []
                for i in range(df.shape[0]):
                    if not bool((df.iloc[i, 3:] > 0).all()):
                        continue
                    xmin = int(df.iloc[i, 3])
                    xmax = int(xmin + df.iloc[i, 5] - 1)
                    ymin = int(df.iloc[i, 4])
                    ymax = int(ymin + df.iloc[i, 6] - 1)
                    gt_boxes.append(
                        {"xmin": xmin, "ymin": ymin, "xmax": xmax, "ymax": ymax}
                    )
                    ratios.append((xmax - xmin) / (ymax - ymin))

                image1 = draw_boxes(image_o, gt_boxes, color=(255, 0, 0))
                pred_boxes = [
                    {"xmin": r[0], "ymin": r[1], "xmax": r[2], "ymax": r[3],
                     "score": r[4]}
                    for r in boxes
                ]
                image2 = draw_boxes(image1, pred_boxes, color=(0, 255, 0))
                out_name = base[:-4] + "_detected" + base[-4:]
                imsave(os.path.join(results_dir, out_name), image2)

        pd.DataFrame({"ratio": ratios}).to_csv("ratios.csv")

    def test(self):
        test_path = self.conf.test_path
        output_file_path = self.conf.output_file_path
        file_names = glob.glob(os.path.join(test_path, "*.jpg"))
        count1 = 1
        with open(output_file_path, "w") as f:
            for fn, _image_o, _geom, boxes in self._iter_detections(
                file_names, int(self.hps["batch_size"])
            ):
                if DEBUG:
                    print(count1, "/", len(file_names), fn)
                count1 += 1
                self._write_rows(f, fn, boxes)


def _parse_cli(argv: list[str]) -> tuple[str | None, list[str]]:
    """(conf_path, overrides) from CLI args. `--set key=value` works in all
    shell forms: two tokens (`--set k=v`), `--set=k=v`, or one quoted token."""
    conf_path = None
    overrides: list[str] = []
    it = iter(argv)
    for a in it:
        if a.startswith("--conf="):
            conf_path = a.split("=", 1)[1]
        elif a == "--conf":
            nxt = next(it, None)
            if nxt is None:
                raise SystemExit("--conf requires a path argument")
            conf_path = nxt
        elif a == "--set":
            nxt = next(it, None)
            if nxt is None:
                raise SystemExit("--set requires a key=value argument")
            overrides.append(nxt)
        elif a.startswith("--set="):
            overrides.append(a.split("=", 1)[1])
        elif a.startswith("--set "):
            overrides.append(a.split(" ", 1)[1])
        else:
            overrides.append(a)
    return conf_path, overrides


def main(argv: list[str] | None = None, *,
         device: torch.device | str | None = None) -> FaceDetectorPipeline:
    """Run the mode `fd_conf.mode` names on `device` (the CUDA card when
    None); returns the pipeline it built."""
    argv = sys.argv[1:] if argv is None else argv
    if any(a == "--mode" or a.startswith("--mode=") for a in argv):
        raise NotImplementedError(
            "the legacy --mode argparse CLI is ROADMAP.md queue 1 item 10; "
            "use --conf=... with fd_conf.* overrides")
    conf_path, overrides = _parse_cli(argv)
    conf = load_conf(conf_path)
    apply_overrides(conf, overrides)
    fd_conf = conf.fd_conf
    fd = FaceDetectorPipeline(fd_conf, device=device)
    ts = time.time()
    if fd_conf.mode == "train":
        fd.train()
    elif fd_conf.mode == "evaluate":
        fd.evaluate()
    elif fd_conf.mode == "test":
        fd.test()
    te = time.time()
    print("Elasped time: {0:f}s".format(te - ts))  # reference output parity
    return fd


if __name__ == "__main__":
    main()
