"""Face identification entry point: data / train / evaluate / test / fid_db.

Port of face_vijnana_yolov3_tpu/api/face_identification.py:45-756
(`FaceIdentifierPipeline`, `main`), with the same files: `solution_fi.csv`
rows `file,subject_id,x,y,w,h,score` (at most 60 written per image),
`results_fi/` overlays in evaluate mode, and the subject DB artifacts of
data/facedb.py. Everything runs on the CUDA card unless the caller passes
`device="cpu"`; without a card the default raises. The nested
FaceDetectorPipeline shares the device and the precision.

    python -m face_vijnana_yolov3_tpu_torch.api.face_identification --conf=CONF.json \
        [fi_conf.mode=data|train|evaluate|test|fid_db]

Each detected box is cropped from the original image with the reference's
`(t-1):(b-1)` slice, letterboxed to the identifier's size, embedded
(models/identifier.py: f32, bf16 folded with the f32 front guard, or int8
through kernel A0) and matched against the registry as one distance matrix
(ops/similarity.py); a match farther than hps.sim_th writes no row. Two
crop paths: the host one (cv2 cubic on the f64 crop / 255, the default)
and `device_roi` (conf.device_roi or FVY_DEVICE_ROI=1: the crops as two
matmuls against the staged original, ops/roi.py, reusing the detector's
staging upload when its device letterbox ran).

Serving replays captured programs (core/programs.py), as the JAX package
serves through jitted ones, one program per size of `_EMBED_BUCKETS`. The
JAX package pads a batch up to the next bucket; the port splits it into
bucket sizes instead (`_bucket_split`: 64s, then the binary digits of the
rest, 17 → 16 + 1) and replays each piece's program: on the card the pad
crops cost more than the extra pieces, and programs at every exact count
would each keep their own transient memory in the graphs' pool (PERF.md
§6). A device-ROI chunk replays, for each piece of its ROIs, one graph of
the windowed crops, the embed and the registry match, keyed as the JAX
`_roi_fused_fn` with the piece's size for its bucket and without n_sub
(on the staged batch dimension, so the detector's padded short last chunk
reuses it). int8 calibrates eagerly, before the first capture.
`_calibrate_int8`, `train` and any `model.load_state_dict` drop every
program. `_embed_program` stays the eager embed that core/export.py
traces.
TripletDataset's generators are seeded from the pipeline's `seed` (None:
fresh entropy, as the JAX package's unseeded ones). Refused:
`bf16_front_mode="int8"` (measured harmful in the JAX package; ROADMAP.md,
code the port should not carry). `train` runs on the mesh of
parallel/mesh.py when the process group is up or `model_axis` > 1 (dense1
tensor parallelism over `model_axis` ranks; `init_distributed` first). The
experimental reconstruction decoder (`create_face_reconst_model`,
`reconstruct`; models/recon.py) keeps its weights in
`face_vijnana_recon_tpu.pt` in the working directory, the JAX package's
checkpoint name with the port's suffix.
"""

from __future__ import annotations

import functools
import glob
import os
import pickle
import shutil
import sys
import time

import numpy as np
import torch

from face_vijnana_yolov3_tpu_torch.api.config import Conf, apply_overrides, load_conf
from face_vijnana_yolov3_tpu_torch.api.face_detection import (
    FaceDetectorPipeline,
    _parse_cli,
    resolve_device,
)
from face_vijnana_yolov3_tpu_torch.convert import identifier_params_from_jax
from face_vijnana_yolov3_tpu_torch.core.checkpoints import (
    KERAS_SUFFIXES,
    load_checkpoint,
    load_opt_state,
)
from face_vijnana_yolov3_tpu_torch.core.programs import ProgramCache, watch_weights
from face_vijnana_yolov3_tpu_torch.models import quant
from face_vijnana_yolov3_tpu_torch.models.identifier import FaceIdentifierModel, init_dense1
from face_vijnana_yolov3_tpu_torch.ops import roi
from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_host
from face_vijnana_yolov3_tpu_torch.ops.similarity import match_embeddings
from face_vijnana_yolov3_tpu_torch.utils.io import imsave

DEBUG = True

RESOURCE_TYPE_UCCS = "uccs"
RESOURCE_TYPE_VGGFACE2 = "vggface2"

_EMBED_BUCKETS = (1, 2, 4, 8, 16, 32, 64)  # embed batch sizes, one program each


def _bucket_split(n: int) -> list[int]:
    """n rows as `_EMBED_BUCKETS` sizes, nothing padded: 64s, then the
    binary digits of the rest, largest first (81 → [64, 16, 1])."""
    big = _EMBED_BUCKETS[-1]
    return [big] * (n // big) + [b for b in reversed(_EMBED_BUCKETS) if n % big & b]


# The reconstruction decoder's checkpoint (the JAX package's
# "face_vijnana_recon_tpu", as a .pt), in the working directory.
RECON_CHECKPOINT = "face_vijnana_recon_tpu.pt"
INT8_CALIB_IMAGES = 16  # int8 calibrates on the first embed's first 16 images


def create_db_fi(fi_conf):
    """`data` mode: build the subject-face DB (reference create_db_fi,
    face_identification.py:78-210). Model-free, like the reference."""
    from face_vijnana_yolov3_tpu_torch.data import facedb

    image_size = (fi_conf.nn_arch.image_size if not isinstance(fi_conf.nn_arch, dict)
                  else fi_conf.nn_arch["image_size"])
    if fi_conf.resource_type == RESOURCE_TYPE_UCCS:
        facedb.create_subject_db_uccs(fi_conf.raw_data_path, image_size)
    elif fi_conf.resource_type == RESOURCE_TYPE_VGGFACE2:
        facedb.create_subject_db_vggface2(fi_conf.raw_data_path, image_size)
    else:
        raise ValueError("resource type is not valid.")


def _row(k: int, subject_id, boxes: np.ndarray) -> dict:
    return {"box_index": k, "subject_id": subject_id,
            "xmin": boxes[k, 0], "ymin": boxes[k, 1],
            "xmax": boxes[k, 2], "ymax": boxes[k, 3], "score": boxes[k, 4]}


class FaceIdentifierPipeline:
    """Identifier lifecycle: weights, embed, subject DB, identify, train."""

    def __init__(self, conf: Conf, *, precision: str = "float32",
                 device: torch.device | str | None = None, seed: int | None = None):
        fi = conf.fi_conf
        if getattr(fi, "bf16_front_mode", "f32") == "int8":
            raise NotImplementedError(
                "fi_conf.bf16_front_mode='int8' is not carried into the port: "
                "it is EXPERIMENTAL and measured harmful in the JAX package "
                "(ROADMAP.md, code the port should not carry)")
        if precision not in ("float32", "bfloat16", "int8"):
            raise NotImplementedError(
                f"precision={precision!r}: the port serves float32, bfloat16 and "
                "int8, the JAX package's serving precisions")
        self.device = resolve_device(device)
        # The f32 contract (JAX Precision.HIGHEST) for the trunk, dense1 and
        # the registry match (FaceDetectorPipeline below sets the same).
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        self.conf = fi
        self.fd_conf = conf.fd_conf
        self.hps = vars(fi.hps) if not isinstance(fi.hps, dict) else fi.hps
        self.nn_arch = vars(fi.nn_arch) if not isinstance(fi.nn_arch, dict) else fi.nn_arch
        self.image_size = self.nn_arch["image_size"]
        self.precision = precision
        self.seed = seed
        self.model = FaceIdentifierModel(image_size=self.image_size,
                                         dense1_dim=self.nn_arch["dense1_dim"],
                                         device=self.device)
        self.opt_state = None  # Adam state of a resumed training run
        if fi.model_loading:
            if fi.model_path.endswith(KERAS_SUFFIXES):
                # Drop-in load of the reference's face_identifier.h5.
                from face_vijnana_yolov3_tpu_torch.core.keras_import import (
                    identifier_from_keras_h5,
                )

                sd = identifier_from_keras_h5(fi.model_path)
            else:
                sd = load_checkpoint(fi.model_path)
                self.opt_state = load_opt_state(fi.model_path)
        elif fi.yolov3_base_model_load and os.path.exists("yolov3_base.h5"):
            # The reference's cached trunk (face_identification.py:397-404), a
            # fresh dense1.
            from face_vijnana_yolov3_tpu_torch.core.keras_import import (
                collect_keras_weights,
                trunk_from_keras,
            )

            sd = trunk_from_keras(collect_keras_weights("yolov3_base.h5"))
            sd.update(identifier_params_from_jax({"dense1": init_dense1(
                2, self.model.flat_dim, self.model.dense1_dim)}, {}))
        elif os.path.exists(fi.weights_path):
            sd = self.model.init_from_darknet(fi.weights_path, seed=1)
            # The same base cache the reference writes (face_identification.py:612).
            from face_vijnana_yolov3_tpu_torch.core.keras_import import (
                save_trunk_keras_h5,
            )

            save_trunk_keras_h5(sd, "yolov3_base.h5")
        else:
            print(f"[face_identification] {fi.weights_path} not found — "
                  "random-initializing trunk")
            sd = identifier_params_from_jax(*self.model.init_params(1))
        self.model.load_state_dict(sd)
        self.model.eval()
        # The captured embed and ROI-chunk programs; new weights make every
        # one stale.
        self.programs = ProgramCache(self.device)
        watch_weights(self.model, self)

        # The nested full detector, as the reference's FaceIdentifier.__init__.
        self.fd = FaceDetectorPipeline(self.fd_conf, precision=precision,
                                       device=self.device)
        self._folded: dict | None = None  # bf16: folded once, on first use
        self._q_embed: dict | None = None  # int8: calibrated on the first embed

    # -------------------------------------------------------------- embedding

    def _weights_changed(self):
        """After `model.load_state_dict`: the folded parameters and every
        captured program read the old weights."""
        self._folded = None
        self.programs.invalidate()

    def _folded_params(self) -> dict:
        if self._folded is None:
            self._folded = self.model.fold()
        return self._folded

    def _calibrate_int8(self, images: torch.Tensor) -> None:
        """Fold and calibrate the int8 trunk on the first 16 of `images`
        (face_identification.py:197-214); dense1 stays bf16."""
        pct = getattr(self.conf, "int8_calib_percentile", 0.0) or None
        self._q_embed = quant.to_device(
            self.model.quantize(
                self._folded_params(), images[:INT8_CALIB_IMAGES], percentile=pct,
                bias_correct=bool(getattr(self.conf, "int8_bias_correct", False))),
            self.device)
        self.programs.invalidate()

    def _ready_to_serve(self):
        """Raise before a capture when int8 is uncalibrated; fold the bf16
        parameters outside the program, which must not allocate them."""
        if self.precision == "int8" and self._q_embed is None:
            raise RuntimeError("int8 precision requires calibration before embed")
        if self.precision == "bfloat16":
            self._folded_params()

    @torch.inference_mode()
    def _embed_tensor(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) f32 on the device, B >= 1 → (B, D) f32 on the
        device, in this pipeline's precision (int8 must be calibrated): the
        pieces of `_bucket_split(B)`, each through its bucket's program
        (the JAX `_embed_fn`, which pads to the bucket instead)."""
        self._ready_to_serve()
        out, s = [], 0
        for b in _bucket_split(x.shape[0]):
            out.append(self.programs.run(("embed", b), self._embed_program, x[s:s + b]))
            s += b
        return torch.cat(out)

    def _embed_program(self, x: torch.Tensor) -> torch.Tensor:
        """The embed `_embed_tensor` runs, outside inference mode (the JAX
        pipeline's `_embed_raw`), which core/export.export_embedder traces."""
        if self.precision == "int8":
            return self.model.embed_quant(self._q_embed, x)
        if self.precision == "bfloat16":
            # The folded bf16 trunk with the f32 front guard: a trained trunk
            # amplifies bf16 rounding of conv_0/1 on rare crops, which rotates
            # the L2-normalized embedding.
            return self.model.embed_folded(
                self._folded_params(), x, compute_dtype=torch.bfloat16,
                f32_front_blocks=int(getattr(self.conf, "bf16_f32_front", 2)))
        return self.model.embed(x)

    def embed_device(self, images) -> torch.Tensor:
        """fid extractor: (B, S, S, 3) float images (numpy, or a tensor) →
        (B, D) embeddings on the device, in bucket pieces (`_embed_tensor`).
        precision='int8' calibrates on the first call's first 16 images."""
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if self.precision == "int8" and self._q_embed is None:
            self._calibrate_int8(x)
        if x.shape[0] == 0:
            return torch.zeros((0, self.model.dense1_dim), device=self.device)
        return self._embed_tensor(x)

    def embed(self, images) -> np.ndarray:
        """`embed_device` as host numpy (the subject DB's embed_fn)."""
        return self.embed_device(images).cpu().numpy()

    # -------------------------------------------------------------- db names

    def _db_names(self):
        if self.conf.resource_type == RESOURCE_TYPE_UCCS:
            return ("subject_image_db.csv", "subject_faces",
                    "subject_facial_ids.h5", "ref_facial_id_db.pickle",
                    "img_triplet_pairs.pickle")
        if self.conf.resource_type == RESOURCE_TYPE_VGGFACE2:
            return ("subject_image_vggface2_db.csv", "subject_faces_vggface2",
                    "subject_facial_vggface2_ids.h5",
                    "ref_facial_id_vggface2_db.pickle",
                    "img_triplet_pairs_vggface2.pickle")
        raise ValueError("resource type is not valid.")

    # -------------------------------------------------------------- modes

    def create_db(self):
        create_db_fi(self.conf)

    def train(self):
        """Train the identifier on the subject DB's triplets
        (face_identification.py:250-307) on this pipeline's device; returns
        the per-step losses. precision "bfloat16" trains in mixed precision,
        "float32" and "int8" in f32. conf.negative_mining, conf.train_remat,
        conf.train_qat and conf.checkpoint_every as in train_identifier. A
        Keras-style model_path (.h5/.hd5, the reference's face_identifier.h5)
        trains against a sibling `<model_path>.pt` and exports the h5 at the
        end. The folded and calibrated programs of the old weights are
        dropped."""
        import random

        from face_vijnana_yolov3_tpu_torch.data.facedb import TripletDataset
        from face_vijnana_yolov3_tpu_torch.models.darknet import split_state_dict
        from face_vijnana_yolov3_tpu_torch.parallel import mesh as mesh_lib
        from face_vijnana_yolov3_tpu_torch.train.trainer import train_identifier

        db_csv, faces_subdir, _, _, pairs_pickle = self._db_names()
        dataset = TripletDataset(
            self.conf.raw_data_path, db_csv=db_csv, faces_subdir=faces_subdir,
            pairs_pickle=pairs_pickle, load_flag=False,
            rng=np.random.default_rng(self.seed), shuffle_rng=random.Random(self.seed))
        keras_h5 = self.conf.model_path.endswith(KERAS_SUFFIXES)
        ckpt_path = self.conf.model_path + ".pt" if keras_h5 else self.conf.model_path
        params, state = split_state_dict(
            {k: v.detach().clone() for k, v in self.model.state_dict().items()})
        params, state, losses = train_identifier(
            self.model, params, state, dataset, self.hps,
            mesh=mesh_lib.default_mesh(int(getattr(self.conf, "model_axis", 1))),
            checkpoint_path=ckpt_path,
            init_opt_state=self.opt_state,
            history_path=ckpt_path + "_history.jsonl",
            compute_dtype=torch.bfloat16 if self.precision == "bfloat16" else None,
            checkpoint_every=getattr(self.conf, "checkpoint_every", 0),
            mining=getattr(self.conf, "negative_mining", "random"),
            remat=getattr(self.conf, "train_remat", False),
            fakequant=getattr(self.conf, "train_qat", False),
        )
        self.model.load_state_dict({**params, **state})
        # New weights (load_state_dict above dropped the folded parameters
        # and the programs): the next embed re-calibrates int8.
        self._q_embed = None
        self.programs.invalidate()
        print("Save the model.")
        if keras_h5 and mesh_lib.is_main_process():
            from face_vijnana_yolov3_tpu_torch.core.keras_import import (
                save_identifier_keras_h5,
            )

            save_identifier_keras_h5(self.model.state_dict(), self.conf.model_path)
        return losses

    def create_face_reconst_model(self):
        """Build (or load) the experimental reconstruction decoder
        (reference create_face_reconst_model, face_identification.py:1155-1488;
        face_identification.py:309-330 of the JAX package): with
        `face_vijana_recon_load` and an existing checkpoint it loads
        RECON_CHECKPOINT, else it initialises from this identifier (bias
        seed RECON_SEED, the JAX package's PRNGKey(2)) and saves it there."""
        from face_vijnana_yolov3_tpu_torch.core.checkpoints import save_checkpoint
        from face_vijnana_yolov3_tpu_torch.models.recon import FaceReconstructionModel

        self.recon_model = FaceReconstructionModel(
            image_size=self.image_size, dense1_dim=self.nn_arch["dense1_dim"],
            device=self.device)
        if self.conf.face_vijana_recon_load and os.path.exists(RECON_CHECKPOINT):
            sd = load_checkpoint(RECON_CHECKPOINT)
        else:
            sd = self.recon_model.init_state_dict(self.model.state_dict())
            save_checkpoint(RECON_CHECKPOINT, sd)
        self.recon_model.load_state_dict(sd)

    @torch.inference_mode()
    def reconstruct(self, facial_ids: np.ndarray) -> np.ndarray:
        """(B, dense1_dim) ids → (B, S, S, 3) reconstructed images (numpy)."""
        if not hasattr(self, "recon_model"):
            self.create_face_reconst_model()
        z = torch.as_tensor(np.asarray(facial_ids, np.float32), device=self.device)
        return self.recon_model(z).cpu().numpy()

    def make_facial_ids_db(self):
        from face_vijnana_yolov3_tpu_torch.data.facedb import make_facial_ids_db

        db_csv, faces_subdir, ids_h5, _, _ = self._db_names()
        make_facial_ids_db(self.embed, self.conf.raw_data_path, db_csv, faces_subdir,
                           ids_h5)

    def register_facial_ids(self):
        from face_vijnana_yolov3_tpu_torch.data.facedb import register_facial_ids

        db_csv, faces_subdir, _, reg_pickle, _ = self._db_names()
        return register_facial_ids(self.embed, self.conf.raw_data_path, db_csv,
                                   faces_subdir, reg_pickle)

    # -------------------------------------------------------------- identify

    def _load_registry(self):
        _, _, _, reg_pickle, _ = self._db_names()
        with open(reg_pickle, "rb") as f:
            registry = pickle.load(f)
        subject_ids = list(registry.keys())
        reg = np.asarray([registry[s] for s in subject_ids], np.float32)
        return subject_ids, reg

    def _identify_image(self, image_o: np.ndarray, boxes: np.ndarray, subject_ids,
                        reg_embs):
        """Host crops → embed → registry match; returns row dicts.

        The reference's crop exactly (face_identification.py:872-912): int()
        box corners, the `(t-1):(b-1)` off-by-one slice of the raw image
        (which wraps when a corner is 0), /255, the INTER_CUBIC letterbox;
        boxes whose crop has zero width or height are skipped.
        """
        crops, keep = [], []
        for k in range(boxes.shape[0]):
            l, t, r, b = (int(boxes[k, 0]), int(boxes[k, 1]),
                          int(boxes[k, 2]), int(boxes[k, 3]))
            crop = image_o[(t - 1):(b - 1), (l - 1):(r - 1), :]
            if crop.shape[0] == 0 or crop.shape[1] == 0:
                continue
            lb, _ = letterbox_host(crop / 255, self.image_size, "cubic")
            crops.append(lb)
            keep.append(k)
        if not crops:
            return []
        embs = self.embed_device(np.asarray(crops, np.float32))
        best_idx, best_dist = match_embeddings(embs, torch.as_tensor(reg_embs))
        best_idx, best_dist = best_idx.cpu().numpy(), best_dist.cpu().numpy()
        return [_row(k, subject_ids[int(best_idx[j])], boxes)
                for j, k in enumerate(keep) if not best_dist[j] > self.hps["sim_th"]]

    def _roi_plan(self, images: list, boxes_list: list, staged_dev=None):
        """The device crops of a detect chunk's boxes (face_identification.py:
        480-526): (owners, plan). owners[r] = (image j, box k) of ROI r for
        each box whose crop is non-empty, in order; plan (None without
        ROIs) holds the staged tensor on the device, each ROI's window
        origin (n, 3) (image, y, x) and its tap tables (ops/roi.py), and
        the bucketed window (wh, ww) every ROI takes of its image.

        staged_dev: the detect pass's (B, maxH, maxW, 3) device staging
        tensor (detect_batch_fused return_staged), so the originals upload
        once; None stages the chunk here, H/W rounded up to 128-multiples:
        uint8 when every image is, else f32 divided by 255 on the host first
        (the device resize takes float pixels as already in [0, 1], while
        the host path always divides the raw crop by 255).
        """
        owners: list[tuple[int, int]] = []  # ROI → (image j, box k)
        wins: list[tuple[int, int, int, int]] = []
        for j, (im, bx) in enumerate(zip(images, boxes_list)):
            keep_j, wins_j = roi.build_roi_windows(bx, im.shape[0], im.shape[1])
            owners.extend((j, k) for k in keep_j)
            wins.extend(wins_j)
        if not owners:
            return owners, None
        if staged_dev is not None:
            staged = staged_dev
        else:
            bh = -(-max(im.shape[0] for im in images) // 128) * 128
            bw = -(-max(im.shape[1] for im in images) // 128) * 128
            dtype = (np.uint8 if all(im.dtype == np.uint8 for im in images)
                     else np.float32)
            host = np.zeros((len(images), bh, bw, 3), dtype)
            for j, im in enumerate(images):
                if dtype == np.uint8:
                    host[j, : im.shape[0], : im.shape[1]] = im
                else:
                    host[j, : im.shape[0], : im.shape[1]] = (
                        np.asarray(im, np.float32) / 255.0)
            staged = torch.from_numpy(host).to(self.device)
        bh, bw = int(staged.shape[1]), int(staged.shape[2])

        # Each ROI takes a bucketed window of its image at its origin, so
        # the matmuls contract over about the crop's extent.
        wh = roi.window_bucket(max(w[2] for w in wins), bh)
        ww = roi.window_bucket(max(w[3] for w in wins), bw)
        origins = np.zeros((len(owners), 3), np.int32)
        for r, ((j, _k), (y0, x0, _ch, _cw)) in enumerate(zip(owners, wins)):
            origins[r] = (j, min(y0, bh - wh), min(x0, bw - ww))
        taps = roi.stack_roi_taps(wins, self.image_size, origins[:, 1:])
        return owners, dict(staged=staged, origins=origins, taps=taps, window=(wh, ww))

    def _roi_crops(self, plan: dict, sl: slice) -> torch.Tensor:
        """The letterboxed crops of `plan`'s ROIs `sl`, (n, S, S, 3) f32 on
        the device, computed eagerly (int8 calibration, checks)."""
        taps = [torch.from_numpy(t[sl]).to(self.device) for t in plan["taps"]]
        wh, ww = plan["window"]
        with torch.inference_mode():
            return roi.roi_letterbox_device_windowed(
                plan["staged"], torch.from_numpy(plan["origins"][sl]).to(self.device),
                *taps, window_h=wh, window_w=ww)

    def _roi_program(self, window_h: int, window_w: int, staged: torch.Tensor,
                     packed: torch.Tensor, reg: torch.Tensor):
        """The program of one piece of an identify chunk (the JAX
        `_roi_fused_fn`'s sub-batch): the windowed crops of the ROIs of
        `packed` (n, F), their embed and the registry match; →
        (best_idx, best_dist), each (n,)."""
        org, ri, rw, ci, cw = roi.unpack_roi_operands(packed, self.image_size)
        crops = roi.roi_letterbox_device_windowed(
            staged, org, ri, rw, ci, cw, window_h=window_h, window_w=window_w)
        return match_embeddings(self._embed_program(crops), reg)

    def _roi_inputs(self, plan: dict, reg_dev) -> list[tuple]:
        """[(key, program, staged, packed, reg)]: the identify programs of
        a chunk's n ROIs, one per piece of `_bucket_split(n)` in ROI order,
        nothing padded; the ROIs' operands go up packed, once. The key is
        the JAX `_roi_fused_fn`'s (:422) without n_sub: (piece size, staged
        batch, H, W, window, registry size, dtype). Keyed on the STAGED
        batch dimension, not the image count: the detector pads its short
        last chunk to batch_size, so that chunk reuses the programs."""
        packed = torch.from_numpy(roi.pack_roi_operands(
            plan["origins"], *plan["taps"])).to(self.device)
        staged = plan["staged"]
        reg = torch.as_tensor(reg_dev, dtype=torch.float32, device=self.device)
        wh, ww = plan["window"]
        fn = functools.partial(self._roi_program, wh, ww)
        shape = tuple(int(d) for d in staged.shape[:3])
        dtype = np.dtype(str(staged.dtype).removeprefix("torch.")).str
        out, s = [], 0
        for b in _bucket_split(packed.shape[0]):
            key = ("roi", b) + shape + (wh, ww, int(reg.shape[0]), dtype)
            out.append((key, fn, staged, packed[s:s + b], reg))
            s += b
        return out

    def _identify_chunk_device(self, images: list, boxes_list: list, subject_ids,
                               reg_dev, staged_dev=None):
        """Device crops for a whole detect chunk (face_identification.py:
        451-597): the ROIs of `_roi_plan` through the programs of
        `_roi_inputs` (crops, embed and registry match), one per
        piece of the ROI count; the host work per box is a tap table. int8
        calibrates on the first 16 real crops, eagerly. The host path's
        semantics (the off-by-one window, the zero-size skip, the sim_th
        gate) at float-rounding parity. Returns per-image row lists.
        """
        out_rows: list[list] = [[] for _ in images]
        owners, plan = self._roi_plan(images, boxes_list, staged_dev)
        if not owners:
            return out_rows
        n = len(owners)
        if self.precision == "int8" and self._q_embed is None:
            self._calibrate_int8(self._roi_crops(plan, slice(0, min(INT8_CALIB_IMAGES, n))))
        self._ready_to_serve()
        idx, dist = zip(*(self.programs.run(*p) for p in self._roi_inputs(plan, reg_dev)))
        best_idx = torch.cat(idx).cpu().numpy()
        best_dist = torch.cat(dist).cpu().numpy()
        for r, (j, k) in enumerate(owners):
            if best_dist[r] > self.hps["sim_th"]:
                continue
            out_rows[j].append(_row(k, subject_ids[int(best_idx[r])], boxes_list[j]))
        return out_rows

    def _identify_image_device(self, image_o: np.ndarray, boxes: np.ndarray,
                               subject_ids, reg_dev, staged_dev=None):
        """Single-image view of `_identify_chunk_device`."""
        staged = staged_dev[None] if staged_dev is not None else None
        return self._identify_chunk_device([image_o], [boxes], subject_ids, reg_dev,
                                           staged_dev=staged)[0]

    def _run_identification(self, draw_results: bool):
        import pandas as pd

        test_path = self.conf.test_path
        output_file_path = self.conf.output_file_path
        file_names = glob.glob(os.path.join(test_path, "*.jpg"))
        subject_ids, reg_embs = self._load_registry()
        device_roi = (os.environ.get("FVY_DEVICE_ROI") == "1"
                      or getattr(self.conf, "device_roi", False))
        reg_dev = torch.from_numpy(reg_embs).to(self.device) if device_roi else None

        gt_groups = None
        if draw_results:
            results_dir = os.path.join(test_path, "results_fi")
            if os.path.isdir(results_dir):
                shutil.rmtree(results_dir)
            os.mkdir(results_dir)
            gt_df = pd.read_csv(os.path.join(test_path, "validation.csv"))
            gt_groups = gt_df.groupby("FILE")

        fd_hps = self.fd_conf.hps
        batch_size = int((vars(fd_hps) if not isinstance(fd_hps, dict)
                          else fd_hps)["batch_size"])

        # scaled_decode=False on both paths: the crops (and the overlays)
        # need full-resolution pixels.
        def _stream():
            if device_roi:
                for chunk, originals, _geoms, boxes_list, staged_dev in (
                    self.fd._iter_detection_chunks(
                        file_names, batch_size, scaled_decode=False, yield_staged=True)
                ):
                    rows_per_img = self._identify_chunk_device(
                        originals, boxes_list, subject_ids, reg_dev,
                        staged_dev=staged_dev)
                    for k, fn in enumerate(chunk):
                        yield fn, originals[k], boxes_list[k], rows_per_img[k]
            else:
                for fn, image_o, _geom, boxes in self.fd._iter_detections(
                    file_names, batch_size, scaled_decode=False,
                ):
                    yield fn, image_o, boxes, self._identify_image(
                        image_o, boxes, subject_ids, reg_embs)

        count1 = 1
        with open(output_file_path, "w") as f:
            for fn, image_o, boxes, rows in _stream():
                if DEBUG:
                    print(count1, "/", len(file_names), fn)
                count1 += 1
                base = fn.split(os.sep)[-1]
                # The reference caps WRITTEN rows at 60 but iterates every
                # box: unmatched boxes do not use up the budget
                # (face_identification.py:867, :941).
                for row in rows[:60]:
                    f.write(
                        f"{base},{row['subject_id']},{row['xmin']},{row['ymin']},"
                        f"{row['xmax'] - row['xmin']},"
                        f"{row['ymax'] - row['ymin']},{row['score']}\n"
                    )

                if not draw_results:
                    continue
                try:
                    df = gt_groups.get_group(base)
                except KeyError:
                    continue
                gt_boxes = []
                for i in range(df.shape[0]):
                    if not bool((df.iloc[i, 3:] > 0).all()):
                        continue
                    xmin = int(df.iloc[i, 3])
                    xmax = int(xmin + df.iloc[i, 5] - 1)
                    ymin = int(df.iloc[i, 4])
                    ymax = int(ymin + df.iloc[i, 6] - 1)
                    gt_boxes.append({"xmin": xmin, "ymin": ymin, "xmax": xmax,
                                     "ymax": ymax, "subject_id": df.iloc[i, 2]})
                if not gt_boxes or boxes.shape[0] == 0:
                    continue
                from face_vijnana_yolov3_tpu_torch.utils.drawing import draw_boxes

                image1 = draw_boxes(image_o, gt_boxes, color=(255, 0, 0))
                pred = [{"xmin": r["xmin"], "ymin": r["ymin"], "xmax": r["xmax"],
                         "ymax": r["ymax"], "score": r["score"],
                         "subject_id": r["subject_id"]} for r in rows]
                image2 = draw_boxes(image1, pred, color=(0, 255, 0))
                out_name = base[:-4] + "_detected" + base[-4:]
                imsave(os.path.join(test_path, "results_fi", out_name), image2)

    def evaluate(self):
        self._run_identification(draw_results=True)

    def test(self):
        self._run_identification(draw_results=False)


def main(argv: list[str] | None = None, *,
         device: torch.device | str | None = None) -> FaceIdentifierPipeline | None:
    """Run the mode `fi_conf.mode` names on `device` (the CUDA card when
    None); returns the pipeline it built (None in data mode, which needs no
    model). train is followed by fid_db and the registry, as in the
    reference (face_identification.py:1716-1776)."""
    argv = sys.argv[1:] if argv is None else argv
    conf_path, overrides = _parse_cli(argv)
    conf = load_conf(conf_path)
    apply_overrides(conf, overrides)
    mode = conf.fi_conf.mode

    ts = time.time()
    fi = None
    if mode == "data":
        create_db_fi(conf.fi_conf)
    elif mode == "train":
        fi = FaceIdentifierPipeline(conf, device=device)
        fi.train()
        fi.make_facial_ids_db()
        fi.register_facial_ids()
    elif mode == "evaluate":
        fi = FaceIdentifierPipeline(conf, device=device)
        fi.evaluate()
    elif mode == "test":
        fi = FaceIdentifierPipeline(conf, device=device)
        fi.test()
    elif mode == "fid_db":
        fi = FaceIdentifierPipeline(conf, device=device)
        fi.make_facial_ids_db()
    te = time.time()
    print("Elasped time: {0:f}s".format(te - ts))  # reference output parity
    return fi


if __name__ == "__main__":
    main()
