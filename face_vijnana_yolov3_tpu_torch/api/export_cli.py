"""Export a serving program into one artifact file (`core/export.py`).

Port of face_vijnana_yolov3_tpu/api/export_cli.py (`fvy-export`):

    python -m face_vijnana_yolov3_tpu_torch.api.export_cli --target detect \\
        --out face_detect.fvyx [--conf face_vijnana_yolov3.json] \\
        [--set fd_conf.model_path=...] [--precision int8 --calib 'val/*.jpg'] \\
        [--batch 8] [--device cuda|cpu]

Targets:
  detect    fused detector: letterboxed images -> (cands, counts)
  embed     fid extractor: crops -> embeddings
  identify  embed + registry match: (crops, registry) -> (emb, idx, dist)

int8 exports need representative calibration images (--calib, a glob of
JPEGs, letterboxed here as the evaluate path letterboxes them). With no
--precision the default is int8 when --calib is given (the headline path),
else the guarded bf16 fallback; --precision float32 keeps reference-parity
arithmetic. An auto-chosen int8 that fails its self-check (the detector's
box-F1 error above 0.05 at the deepest bf16 tail, or an FI match-flip rate
above 5 % against f32) falls back to bf16; an explicit --precision int8 is
exported with a warning. --device replaces the JAX CLI's --platforms: the
artifact runs on the device it was exported on (default: the CUDA card).
"""

from __future__ import annotations

import glob
import sys

import numpy as np

from face_vijnana_yolov3_tpu_torch.api.config import apply_overrides, load_conf


def _load_calib(pattern: str, image_size: int, limit: int = 32) -> np.ndarray:
    """Glob JPEGs -> (N,S,S,3) f32 letterboxed batch (reference /255-then-
    resize order, face_detection.py:113)."""
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_host
    from face_vijnana_yolov3_tpu_torch.utils.io import imread

    files = sorted(glob.glob(pattern))[:limit]
    if not files:
        raise SystemExit(f"--calib {pattern!r} matched no files")
    batch = [letterbox_host(imread(f).astype(np.float32) / 255.0, image_size)[0]
             for f in files]
    return np.stack(batch)


def _parse(argv: list[str]) -> dict:
    flags = {"--conf": "conf", "--set": "set", "--target": "target", "--out": "out",
             "--precision": "precision", "--batch": "batch", "--calib": "calib",
             "--device": "device"}
    args = {"conf": None, "set": [], "target": None, "out": None, "precision": None,
            "batch": None, "calib": None, "device": None}
    it = iter(argv)
    for a in it:
        flag, eq, val = a.partition("=")
        if flag not in flags:
            raise SystemExit(f"unknown argument {a!r}")
        if not eq:
            val = next(it, None)
            if val is None:
                raise SystemExit(f"{flag} requires an argument")
        key = flags[flag]
        if key == "set":
            args["set"].append(val)
        else:
            args[key] = int(val) if key == "batch" else val
    return args


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns the written artifact's header."""
    args = _parse(sys.argv[1:] if argv is None else argv)
    target, out, calib = args["target"], args["out"], args["calib"]
    if target not in ("detect", "embed", "identify"):
        raise SystemExit("--target must be detect, embed, or identify")
    if not out:
        raise SystemExit("--out is required")
    precision = args["precision"]
    auto_precision = precision is None
    if precision is None:
        precision = "int8" if calib else "bfloat16"
        print(f"[fvy-export] no --precision given: defaulting to {precision} "
              + ("(int8-auto calibrated on --calib images)" if calib else
                 "(guarded bf16 fallback — pass --calib for the faster int8-auto "
                 "serving default)"))
    if precision == "int8" and calib is None:
        raise SystemExit("--precision int8 requires --calib")

    conf = load_conf(args["conf"])
    apply_overrides(conf, args["set"])
    device = args["device"]

    from face_vijnana_yolov3_tpu_torch.core import export as fvy_export

    if target == "detect":
        from face_vijnana_yolov3_tpu_torch.api.face_detection import FaceDetectorPipeline

        fd = FaceDetectorPipeline(conf.fd_conf, precision=precision, device=device)
        if precision == "int8":
            fd.calibrate_int8(_load_calib(calib, fd.image_size))
            # The calibration self-check (quantize_autotail): int8 damage that
            # no bf16 tail covers would ship a silently broken model.
            err = getattr(fd, "int8_calib_err", 0.0)
            if err > 0.05:
                msg = (f"int8 calibration self-check FAILED (1-boxF1 {err:.3f} at "
                       f"bf16 tail {getattr(fd, 'int8_tail_chosen', 0)}) — this "
                       "checkpoint does not serve accurately in int8")
                if auto_precision:
                    print(f"[fvy-export] {msg}; falling back to guarded bf16")
                    fd = FaceDetectorPipeline(conf.fd_conf, precision="bfloat16",
                                              device=device)
                else:
                    print(f"[fvy-export] WARNING: {msg}; exporting the explicitly "
                          "requested int8 anyway")
        header = fvy_export.export_detector(fd, out, batch=args["batch"])
    else:
        from face_vijnana_yolov3_tpu_torch.api.face_identification import (
            FaceIdentifierPipeline,
        )

        fi = FaceIdentifierPipeline(conf, precision=precision, device=device)
        if precision == "int8":
            calib_batch = _load_calib(calib, fi.image_size)
            fi.embed(calib_batch)  # calibrates the int8 trunk on its first batch
            # Each int8 calibration embedding must match its own f32 twin among
            # the f32 embeddings of all calibration crops (a label-free gate).
            flip = _fi_int8_flip_rate(fi, conf, calib_batch)
            if flip > 0.05:
                msg = (f"FI int8 self-check FAILED (match-flip-rate {flip:.1%} vs "
                       f"f32 on {len(calib_batch)} calibration crops)")
                if auto_precision:
                    print(f"[fvy-export] {msg}; falling back to guarded bf16")
                    fi = FaceIdentifierPipeline(conf, precision="bfloat16",
                                                device=device)
                else:
                    print(f"[fvy-export] WARNING: {msg}; exporting the explicitly "
                          "requested int8 anyway")
            else:
                print(f"[fvy-export] FI int8 self-check passed (match-flip-rate "
                      f"{flip:.1%})")
        header = fvy_export.export_embedder(fi, out, batch=args["batch"],
                                            with_registry=(target == "identify"))
    print(f"[fvy-export] wrote {out}: {header}")
    return header


def _fi_int8_flip_rate(fi, conf, calib_batch: np.ndarray) -> float:
    """Fraction of calibration crops whose int8 embedding's nearest f32
    embedding is NOT its own f32 twin (export_cli.py:213-229)."""
    import torch

    from face_vijnana_yolov3_tpu_torch.api.face_identification import (
        FaceIdentifierPipeline,
    )
    from face_vijnana_yolov3_tpu_torch.ops.similarity import match_embeddings

    fi32 = FaceIdentifierPipeline(conf, precision="float32",
                                  device=getattr(fi, "device", None))
    emb32 = torch.as_tensor(fi32.embed(calib_batch))
    emb8 = torch.as_tensor(np.asarray(fi.embed(calib_batch)))
    idx8, _ = match_embeddings(emb8, emb32)
    return float((idx8.cpu().numpy() != np.arange(len(calib_batch))).mean())


if __name__ == "__main__":
    main()
