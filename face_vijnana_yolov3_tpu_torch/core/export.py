"""Serialized serving artifacts (`torch.export`).

Port of face_vijnana_yolov3_tpu/core/export.py: the fused serving program
(trunk → head → decode + NMS + candidate selection for detection; trunk →
dense1 → L2 normalize, optionally → registry match, for identification)
is exported with `torch.export`, its weights held in the program, and
written as ONE file that `load_artifact` turns back into a callable with
no pipeline, checkpoint or config on the serving host.

File format (little-endian), as the JAX package's:
  bytes 0-3   magic b"FVYX"
  bytes 4-7   u32 header length H
  bytes 8-..  UTF-8 JSON header (kind, precision, shape contract,
              thresholds, torch version, device, format_version)
  rest        `torch.export.save` of the ExportedProgram

Differences from the JAX artifact: the header names `torch_version` and
`device` where it had `jax_version` and `platforms`: an exported program
holds device-placed weights and runs on the device it was exported on (the
CUDA card by default, as every entry point of the port). The JAX program
carries Precision.HIGHEST in its HLO; a torch program reads the TF32 flags
of the process that runs it, so a call runs with TF32 off (the f32
contract of the pipelines). The port's kernels
are the custom ops `fvy::*` (ops/library.py), so an artifact exported from
an int8 pipeline runs kernels A0, A and B on the card; loading imports that
module and nothing of the pipelines.

The batch dimension is symbolic (`torch.export.Dim("b", min=1)`), traced at
a batch of 2 so that no size is specialised to 0 or 1, and the registry
rows of an `identify` artifact are symbolic too (`Dim("r", min=1)`).
"""

from __future__ import annotations

import io
import json
import struct
from dataclasses import dataclass
from typing import Any

import torch

_MAGIC = b"FVYX"
FORMAT_VERSION = 1
TRACE_BATCH = 2  # batch the symbolic programs are traced at (no 0/1 specialisation)


class _Program(torch.nn.Module):
    """A serving function as a module. The tensors it reads (module
    weights, qparams, folded weights) are lifted into the program as
    constants, only those the program uses: an int8 artifact carries the
    int8 weights and not the f32 model they were quantized from."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, args: tuple, dynamic_shapes: tuple):
    with torch.no_grad():
        # forward(*args): the dynamic shapes of the one varargs tuple.
        return torch.export.export(_Program(fn).eval(), args,
                                   dynamic_shapes=(dynamic_shapes,))


def _batch_dim(batch: int | None):
    return None if batch is not None else torch.export.Dim("b", min=1)


def save_artifact(path: str, exported, header: dict) -> None:
    header = dict(header)
    header["format_version"] = FORMAT_VERSION
    header.setdefault("torch_version", torch.__version__)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(blob)))
        f.write(blob)
        f.write(buf.getvalue())


@dataclass
class LoadedArtifact:
    """A deserialized serving program: `meta` (the JSON header) and a
    callable taking tensors or arrays (moved to the artifact's device)."""

    meta: dict
    exported: Any

    def __post_init__(self):
        self._module = self.exported.module()
        self.device = torch.device(self.meta["device"])

    def __call__(self, *args):
        from face_vijnana_yolov3_tpu_torch.models.darknet import exact_f32

        args = tuple(torch.as_tensor(a, device=self.device) for a in args)
        # The f32 contract is a flag of the process, not of the program:
        # TF32 off for the f32 convs and matmuls, as the pipelines set it.
        with torch.inference_mode(), exact_f32():
            return self._module(*args)


def load_artifact(path: str) -> LoadedArtifact:
    # Register fvy::* before the program that calls them is deserialized.
    from face_vijnana_yolov3_tpu_torch.ops import library  # noqa: F401

    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a FVYX serving artifact (magic {magic!r})")
        (hlen,) = struct.unpack("<I", f.read(4))
        meta = json.loads(f.read(hlen).decode("utf-8"))
        if meta.get("format_version", 0) > FORMAT_VERSION:
            raise ValueError(
                f"{path}: format_version {meta['format_version']} is newer "
                f"than this reader ({FORMAT_VERSION})")
        payload = f.read()
    return LoadedArtifact(meta=meta, exported=torch.export.load(io.BytesIO(payload)))


# --------------------------------------------------------------- detection


def export_detector(pipeline, path: str, *, batch: int | None = None) -> dict:
    """Export a FaceDetectorPipeline's serving program (`_detect_program`).

    The artifact maps (B, S, S, 3) f32 letterboxed images in [0, 1] on the
    pipeline's device → (cands (B, num_cands, 6), counts (B,) int32), rows
    [xmin, ymin, xmax, ymax, objness, score] in net coords: the
    detect_batch contract. int8 pipelines must be calibrated first
    (calibrate_int8), and serve their `int8_pallas_blocks` choice. A bf16
    pipeline whose "auto" guard has not been probed exports the depth
    `_bf16_front_depth` gives now (2, the conservative one), recorded in the
    header. A bf16 pipeline with the int8 guard (`bf16_front_mode="int8"`)
    exports its quant route, calibrated first as int8. batch=None exports a
    symbolic batch. Returns the header.
    """
    if pipeline._needs_calibration():
        raise RuntimeError("int8 detector export requires calibrate_int8() first")
    if pipeline.precision == "bfloat16" and not pipeline._hybrid_front:
        pipeline._folded_params()  # fold now: a fold inside the trace caches fakes
    n = TRACE_BATCH if batch is None else int(batch)
    size = pipeline.image_size
    x = torch.zeros((n, size, size, 3), dtype=torch.float32, device=pipeline.device)
    exported = _export(pipeline._detect_program, (x,),
                       ({0: _batch_dim(batch)},))
    cfg = pipeline._pp_cfg
    header = {
        "kind": "face_detect",
        "precision": pipeline.precision,
        "image_size": size,
        "batch": batch,
        "num_cands": cfg.num_cands,
        "conf_th": cfg.conf_th,
        "nms_iou_th": cfg.nms_iou_th,
        "device": str(pipeline.device),
        "inputs": "images (B,S,S,3) f32 letterboxed in [0,1]",
        "outputs": "cands (B,num_cands,6) [x0,y0,x1,y1,obj,score] net "
                   "coords; counts (B,) int32",
    }
    if pipeline.precision == "int8":
        header["int8_pallas_blocks"] = bool(getattr(pipeline.conf, "int8_pallas_blocks",
                                                    False))
    if pipeline.precision == "bfloat16":
        header["bf16_f32_front"] = pipeline._bf16_front_depth()
        header["bf16_front_mode"] = "int8" if pipeline._hybrid_front else "f32"
    save_artifact(path, exported, header)
    return header


# ------------------------------------------------------------ identification


def export_embedder(pipeline, path: str, *, batch: int | None = None,
                    with_registry: bool = True) -> dict:
    """Export a FaceIdentifierPipeline's embed (+ registry match) program.

    with_registry=True: (crops (B, S, S, 3) f32, registry (R, D) f32) →
    (embeddings (B, D), best_idx (B,) int32, best_dist (B,)); the registry
    is an argument with R symbolic, so enrolling never re-exports.
    with_registry=False: crops → embeddings. An int8 pipeline, or a bf16
    one with the int8 guard, must have embedded once (that calibrates it).
    Returns the header.
    """
    if pipeline._needs_calibration():
        raise RuntimeError(
            "int8 embedder export requires calibration first — call .embed() on "
            "a representative batch before export_embedder()")
    from face_vijnana_yolov3_tpu_torch.ops.similarity import match_embeddings

    if pipeline.precision == "bfloat16" and not pipeline._hybrid_front:
        pipeline._folded_params()  # fold now: a fold inside the trace caches fakes
    size = pipeline.image_size
    dim = pipeline.model.dense1_dim
    n = TRACE_BATCH if batch is None else int(batch)
    crops = torch.zeros((n, size, size, 3), dtype=torch.float32, device=pipeline.device)
    if with_registry:
        def run(crops, registry):
            emb = pipeline._embed_program(crops)
            idx, dist = match_embeddings(emb, registry)
            return emb, idx, dist

        reg = torch.zeros((3, dim), dtype=torch.float32, device=pipeline.device)
        exported = _export(run, (crops, reg),
                           ({0: _batch_dim(batch)}, {0: torch.export.Dim("r", min=1)}))
        outputs = ("embeddings (B,D) f32; best_idx (B,) int32; "
                   "best_dist (B,) f32 — gate with hps['sim_th']")
        inputs = ("crops (B,S,S,3) f32 letterboxed in [0,1]; "
                  "registry (R,D) f32 mean embeddings")
    else:
        exported = _export(pipeline._embed_program, (crops,),
                           ({0: _batch_dim(batch)},))
        outputs = "embeddings (B,D) f32 (L2-normalized)"
        inputs = "crops (B,S,S,3) f32 letterboxed in [0,1]"
    header = {
        "kind": "face_embed",
        "precision": pipeline.precision,
        "image_size": size,
        "embed_dim": dim,
        "batch": batch,
        "with_registry": with_registry,
        "device": str(pipeline.device),
        "inputs": inputs,
        "outputs": outputs,
    }
    save_artifact(path, exported, header)
    return header
