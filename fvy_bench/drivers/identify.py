"""Driver of the identification cells: each chunk of decoded frames is
detected by `FaceDetectorPipeline.detect_batch_fused(..., return_staged=
True)`, its rows built as the stream's, and its faces identified by
`FaceIdentifierPipeline._identify_chunk_device` from the staged frames on
the card (the ROI crops, the embed and the registry match, one captured
program per piece of the ROI count).

The traffic sets the boxes: with seeded random weights the detector's own
boxes say nothing about where the faces are, so each frame's painted faces
are its boxes (1-3 a frame). Set-up makes both models' weights on the card,
the ring of pinned chunks and the registry: one painted face per subject,
embedded through the program (which calibrates the int8 identifier on its
first 16), then serves one chunk with 127 boxes, whose pieces (64, 32, 16,
8, 4, 2, 1) capture every ROI program the window can reach, and
`warmup_chunks` more. The check compares a sample of the window's chunks
with the plain reference: the detect rows (`check.box_miss`) and the
identities (`reference.identifier.id_gap`).
"""

from __future__ import annotations

import gc
import json
import time

import numpy as np
import torch

from fvy_bench.drivers.stream import (
    SPAN_NAMES as STREAM_SPANS,
    Reference as DetectReference,
    add_least,
    detect_int8_least,
    int8_launch_least,
    net_pixel,
    pinned_ring,
    rows_of,
    serve_least_s,
    upload_queue,
)
from fvy_bench.harness import costs
from fvy_bench.harness.check import box_miss, verdict
from fvy_bench.harness.traffic import make_scenes
from fvy_bench.harness.trace import profiled, reduce_trace
from fvy_bench.harness.weights import detector_state_dict, identifier_state_dict
from fvy_bench.reference.identifier import Embedder, crop, distances, id_gap

SPAN_NAMES = STREAM_SPANS + ("identify_chunk", "roi_plan")
# ROI pieces the program runs a chunk in (api/face_identification._bucket_split):
# one warm-up chunk of their sum captures each.
WARM_ROIS = 64 + 32 + 16 + 8 + 4 + 2 + 1


def box_rows(faces: np.ndarray) -> np.ndarray:
    """A frame's painted faces as detect rows [xmin, ymin, xmax, ymax, 1]."""
    cx, cy, r = faces[:, 0], faces[:, 1], faces[:, 2]
    return np.stack([cx - r, cy - r, cx + r - 1, cy + r - 1, np.ones_like(cx)], 1).astype(
        np.float64)


def front_detector(ctx) -> dict:
    """The configuration of the detector in front (the identifier
    configuration's `front_detector` file)."""
    return json.loads((ctx.root / ctx.config["front_detector"]).read_text())


def registry_images(ctx) -> torch.Tensor:
    """The registry's faces, one a subject: (N, S, S, 3) f32 in [0, 1]."""
    reg = dict(ctx.traffic, **ctx.traffic["registry"])
    frames, _ = make_scenes(reg, ctx.seed + 2, ctx.device, n=reg["subjects"])
    return frames.to(torch.float32) / 255.0


def build(ctx, fd_arch, sd_fd, sd_fi):
    """The program: a FaceIdentifierPipeline of the configuration with its
    nested detector, the cell's settings and the seeded weights."""
    from face_vijnana_yolov3_tpu_torch.api.config import Conf
    from face_vijnana_yolov3_tpu_torch.api.face_identification import FaceIdentifierPipeline

    conf = Conf()
    missing = str(ctx.root / "fvy_bench" / "no.weights")
    fd, fi = conf.fd_conf, conf.fi_conf
    fd.weights_path = fi.weights_path = missing
    fd.nn_arch.image_size = fd_arch["image_size"]
    fd.hps.batch_size = ctx.traffic["chunk"]
    fd.hps.num_cands = fd_arch["num_cands"]
    fd.hps.face_conf_th = fd_arch["face_conf_th"]
    fd.hps.nms_iou_th = fd_arch["nms_iou_th"]
    fi.nn_arch.image_size = ctx.config["image_size"]
    fi.nn_arch.dense1_dim = ctx.config["dense1_dim"]
    for k, v in ctx.cell.get("detector_conf", {}).items():
        setattr(fd, k, v)
    for k, v in ctx.cell.get("hps", {}).items():
        setattr(fi.hps, k, v)
    pipe = FaceIdentifierPipeline(conf, precision=ctx.cell["precision"], device=ctx.device)
    pipe.fd.model.load_state_dict(sd_fd)
    pipe.model.load_state_dict(sd_fi)
    return pipe


def run(ctx) -> dict:
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_geometry

    tp, cell, dev, spans = ctx.traffic, ctx.cell, ctx.device, ctx.spans
    fd_arch = front_detector(ctx)
    chunk, precision = tp["chunk"], cell["precision"]
    sd_fd = detector_state_dict(fd_arch, ctx.seed, dev)
    sd_fi = identifier_state_dict(ctx.config, ctx.seed + 1, dev)
    frames, faces = make_scenes(tp, ctx.seed, dev)
    ring = pinned_ring(frames, chunk)
    del frames
    boxes = [box_rows(f) for f in faces]
    h, w = tp["height"], tp["width"]
    geoms = [letterbox_geometry(h, w, fd_arch["image_size"])] * chunk
    views = [r.numpy() for r in ring]  # the frames' shapes, as the ROI plan reads them
    pipe = build(ctx, fd_arch, sd_fd, sd_fi)
    subjects = list(range(tp["registry"]["subjects"]))
    reg_dev = pipe.embed_device(registry_images(ctx))
    roi_plan = pipe._roi_plan

    def timed_plan(*a, **kw):
        with spans.span("roi_plan"):
            return roi_plan(*a, **kw)

    pipe._roi_plan = timed_plan
    loaded, close = upload_queue(ring, tp["prefetch"], dev)

    def serve(slot_boxes=None):
        with spans.span("prefetch_wait"):
            staged, slot = next(loaded)
        taken = time.perf_counter()
        with spans.span("detect_batch_fused"):
            cands, counts, staged_dev = pipe.fd.detect_batch_fused(
                staged, geoms, pad_batch_to=chunk, return_staged=True)
        with spans.span("unletterbox"):
            rows = rows_of(cands, counts, geoms)
        frame_boxes = slot_boxes or boxes[slot * chunk:(slot + 1) * chunk]
        with spans.span("identify_chunk"):
            ids = pipe._identify_chunk_device(list(views[slot]), frame_boxes, subjects,
                                              reg_dev, staged_dev=staged_dev)
        return slot, rows, ids, taken, time.perf_counter()

    # One chunk with WARM_ROIS boxes: each frame's faces repeated.
    counts_warm = [WARM_ROIS // chunk + (k < WARM_ROIS % chunk) for k in range(chunk)]
    serve([np.resize(boxes[k], (n, 5)) for k, n in enumerate(counts_warm)])
    for _ in range(cell["warmup_chunks"]):
        serve()
    ctx.sync()
    window = []
    with profiled(ctx.trace) as prof:
        with spans.span("window"):
            t0 = time.perf_counter()
            while True:
                window.append(serve())
                if window[-1][4] - t0 >= ctx.seconds:
                    break
    t1 = window[-1][4]
    close()
    frames_done = len(window) * chunk
    e2e = {"identify_img_s": frames_done / (t1 - t0), "setup_s": t0 - ctx.t_start}
    tail = int(getattr(pipe.fd, "int8_tail_chosen", 0) or 0)
    n_rois = sum(len(boxes[s * chunk + k]) for s, *_ in window for k in range(chunk))
    g = ctx.config["image_size"]
    record = {"chunks": len(window), "frames": frames_done, "window_s": t1 - t0,
              "chunk_ms": [(d - t) * 1e3 for *_, t, d in window],
              "serve_least_s_per_frame": (
                  serve_least_s(fd_arch, precision, tail, 0, h, w)
                  + n_rois / frames_done * embed_least_s(ctx.config, g)),
              "host_s": sum(b - a for n, a, b in spans.items
                            if n in ("unletterbox", "roi_plan") and a >= t0),
              "int8_least": int8_least(ctx.config, fd_arch, chunk, tail, bool(
                  getattr(pipe.fd.conf, "int8_pallas_blocks", False)),
                  [sum(len(boxes[slot * chunk + k]) for k in range(chunk))
                   for slot, *_ in window])}
    tr = reduce_trace(prof, SPAN_NAMES) if prof is not None else None
    peak = ctx.memory_peak()
    del pipe, reg_dev, loaded, close
    gc.collect()
    ctx.free()
    rng = np.random.default_rng(ctx.seed + 7)
    picks = sorted(rng.choice(len(window), size=min(cell["check_chunks"], len(window)),
                              replace=False).tolist())
    t_ref = time.perf_counter()
    slots = [window[i][0] for i in picks]
    det_want = _DetectRef(ctx, fd_arch, sd_fd, ring).rows_of(slots)
    det_prog = [r for i in picks for r in window[i][1]]
    rois, dist = reference_distances(ctx, Embedder(ctx.config, sd_fi), ring, boxes, slots)
    ids = [{r["box_index"]: r["subject_id"] for r in window[i][2][j]}
           for i in picks for j in range(chunk)]
    prog_ids = [ids[n * chunk + j].get(k) for n, j, k in rois]
    numbers = {"box_miss": box_miss(det_prog, det_want, net_pixel(ctx)),
               "id_gap": id_gap(prog_ids, dist, cell["hps"]["sim_th"])}
    ok, checks = verdict(numbers, cell["limits"])
    info = {"frames_compared": len(det_prog), "rois_compared": len(prog_ids),
            "rois_per_frame": n_rois / frames_done, "program_tail": tail,
            "reference_s": time.perf_counter() - t_ref}
    return dict(e2e=e2e, record=record, trace=tr, correct=ok, checks=checks, info=info,
                attempted=frames_done, failed=0, memory_peak_bytes=peak)


def pieces(n: int) -> list[int]:
    """The program's pieces of n ROIs: 64s, then the binary digits of the
    rest (api/face_identification._bucket_split)."""
    return [64] * (n // 64) + [b for b in (32, 16, 8, 4, 2, 1) if n % 64 & b]


def int8_least(arch: dict, fd_arch: dict, chunk: int, tail: int, blocks: bool,
               rois: list[int]) -> dict:
    """`int8_launch_least` of the window's chunks: each chunk's detect, and
    the identifier's int8 walk (A0 on every conv) of each piece of its
    ROIs."""
    total = add_least({}, detect_int8_least(fd_arch, chunk, tail, blocks), len(rois))
    convs = costs.trunk_convs(arch)
    for n in rois:
        for b in pieces(n):
            add_least(total, int8_launch_least(convs, b, False))
    return total


def embed_least_s(arch: dict, s: int) -> float:
    """Least time of one crop: its letterbox GEMMs (a 128² window to S²)
    at f32, the int8 trunk, dense1 at bf16."""
    convs = sum(costs.conv_flops(cv) for cv in costs.trunk_convs(arch))
    g = s // 32
    dense = 2 * g * g * arch["trunk_channels"] * arch["dense1_dim"]
    crop = 2 * s * 128 * 128 * 3 + 2 * s * 128 * s * 3
    return crop / costs.PEAK_F32 + convs / costs.PEAK_INT8 + dense / costs.PEAK_BF16


class _DetectRef(DetectReference):
    """The stream cells' detect reference, on the identify cell's detector."""

    def __init__(self, ctx, fd_arch, sd, ring, control=None):
        ctx_fd = type(ctx)(**{**vars(ctx), "config": fd_arch,
                              "cell": {"precision": ctx.cell["precision"],
                                       "conf": ctx.cell.get("detector_conf", {})}})
        super().__init__(ctx_fd, sd, ring, control)


def reference_distances(ctx, emb: Embedder, ring, boxes, slots):
    """The ROIs of the chunks of ring `slots` with a non-empty crop, as
    (n, frame j, box k), and their (ROIs, registry) distances: `emb`'s
    embedding of each crop against its own of the registry."""
    s, chunk = ctx.config["image_size"], ctx.traffic["chunk"]
    reg_emb = emb.embed(registry_images(ctx))
    rois, crops = [], []
    for n, slot in enumerate(slots):
        frames = ring[slot].to(ctx.device)
        for j in range(chunk):
            for k, box in enumerate(boxes[slot * chunk + j]):
                c = crop(frames[j], box, s)
                if c is not None:
                    rois.append((n, j, k))
                    crops.append(c)
    return rois, distances(emb.embed(torch.stack(crops)), reg_emb).cpu().numpy()


def readings(ctx, control: dict) -> dict:
    """The control's numbers: the reference at int4 put in the program's
    place (its detect rows, and for each ROI its nearest row of its own
    registry) against the reference."""
    fd_arch = front_detector(ctx)
    sd_fd = detector_state_dict(fd_arch, ctx.seed, ctx.device)
    sd_fi = identifier_state_dict(ctx.config, ctx.seed + 1, ctx.device)
    frames, faces = make_scenes(ctx.traffic, ctx.seed, ctx.device)
    ring = pinned_ring(frames, ctx.traffic["chunk"])
    del frames
    boxes = [box_rows(f) for f in faces]
    rng = np.random.default_rng(ctx.seed + 7)
    slots = rng.choice(len(ring), size=min(ctx.cell["check_chunks"], len(ring)),
                       replace=False).tolist()
    want = _DetectRef(ctx, fd_arch, sd_fd, ring).rows_of(slots)
    low = _DetectRef(ctx, fd_arch, sd_fd, ring, control).rows_of(slots)
    _, dist = reference_distances(ctx, Embedder(ctx.config, sd_fi), ring, boxes, slots)
    _, low_dist = reference_distances(ctx, Embedder(ctx.config, sd_fi, qmax=control["qmax"]),
                                      ring, boxes, slots)
    return {"box_miss": box_miss(low, want, net_pixel(ctx)),
            "id_gap": id_gap(low_dist.argmin(-1).tolist(), dist, ctx.cell["hps"]["sim_th"])}
