"""Driver of the detection stream cells: the test mode's batch job over
decoded frames, served by `FaceDetectorPipeline.detect_batch_fused` in a
closed loop.

Set-up makes the weights on the card, paints a ring of distinct chunks
into pinned host memory (a decoder that writes into pinned buffers), builds
the program and runs `warmup_chunks` chunks through the window's own loop
(the first calibrates int8 and captures the fused program). The window
then takes chunk after chunk off the program's upload queue
(`data/pipeline.prefetch_batches`, which pins, here a no-op, and uploads
non_blocking) and, for each, serves it (`detect_batch_fused(staged, geoms,
pad_batch_to=chunk)`), maps the candidates back (`unletterbox_boxes_chunk`)
and builds each frame's rows, as `_iter_detection_chunks` does. A chunk is
timed from when the loop takes it off the queue to its rows on the host.
After the window a sample of the window's chunks, drawn from the seed, is
served by the plain reference from the same frames and weights, and the
rows are compared (`check.box_miss`).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from fvy_bench.harness import costs
from fvy_bench.harness.check import box_miss, verdict
from fvy_bench.harness.traffic import make_scenes
from fvy_bench.harness.trace import profiled, reduce_trace
from fvy_bench.harness.weights import detector_state_dict
from fvy_bench.reference.detector import Detector

SPAN_NAMES = ("prefetch_wait", "detect_batch_fused", "unletterbox")


class _Closed(Exception):
    """Raised in the upload thread once the window has closed."""


def build_detector(ctx, sd, precision: str):
    """The program: a FaceDetectorPipeline of the configuration, with the
    cell's settings and the seeded weights."""
    from face_vijnana_yolov3_tpu_torch.api.config import FdConf
    from face_vijnana_yolov3_tpu_torch.api.face_detection import FaceDetectorPipeline

    arch, cell = ctx.config, ctx.cell
    conf = FdConf(weights_path=str(ctx.root / "fvy_bench" / "no.weights"))
    conf.nn_arch.image_size = arch["image_size"]
    conf.nn_arch.bb_info_c_size = arch["head_channels"]
    conf.hps.batch_size = ctx.traffic["chunk"]
    conf.hps.num_cands = arch["num_cands"]
    conf.hps.face_conf_th = arch["face_conf_th"]
    conf.hps.nms_iou_th = arch["nms_iou_th"]
    for k, v in cell.get("conf", {}).items():
        setattr(conf, k, v)
    fd = FaceDetectorPipeline(conf, precision=precision, device=ctx.device)
    fd.model.load_state_dict(sd)
    return fd


def pinned_ring(frames: torch.Tensor, chunk: int) -> list[torch.Tensor]:
    """The frames as host chunks, pinned when a card is there."""
    pin = torch.cuda.is_available() and frames.device.type == "cuda"
    ring = []
    for s in range(0, frames.shape[0], chunk):
        host = torch.empty(frames[s:s + chunk].shape, dtype=frames.dtype, pin_memory=pin)
        host.copy_(frames[s:s + chunk])
        ring.append(host)
    return ring


def _first_conv_of_block(convs: list[dict], block: int) -> int:
    return min(cv["idx"] for cv in convs if cv["block"] and cv["block"][1] == block)


def serve_least_s(arch: dict, precision: str, tail: int, guard: int, h: int, w: int) -> float:
    """Least time of one frame's work at the H100's dense peaks: the two
    letterbox GEMMs at f32, the trunk's convs at the precision each runs in
    (int8 up to a bf16 tail of `tail` blocks; bf16 after an f32 guard of
    `guard` segments), the head at bf16 (f32 at float32)."""
    s = arch["image_size"]
    convs = costs.trunk_convs(arch)
    n_blocks = max(cv["block"][1] for cv in convs if cv["block"]) + 1
    t = (2 * s * h * w * 3 + 2 * s * w * s * 3) / costs.PEAK_F32
    cut = _first_conv_of_block(convs, n_blocks - tail) if tail else float("inf")
    front = _first_conv_of_block(convs, guard - 1) if guard else -1
    for cv in convs:
        if precision == "int8":
            peak = costs.PEAK_BF16 if cv["idx"] >= cut else costs.PEAK_INT8
        elif precision == "bfloat16":
            peak = costs.PEAK_F32 if cv["idx"] < front else costs.PEAK_BF16
        else:
            peak = costs.PEAK_F32
        t += costs.conv_flops(cv) / peak
    g = s // 32
    head = 2 * g * g * 9 * arch["trunk_channels"] * arch["head_channels"]
    return t + head / (costs.PEAK_F32 if precision == "float32" else costs.PEAK_BF16)


def int8_launch_least(convs: list[dict], batch: int, blocks: bool, cut=float("inf")) -> dict:
    """{"conv_int8": [least s, launches], "block_int8": [...]} of one int8
    walk of `convs` at `batch` up to the conv index `cut`: each launch's
    least time from its shapes (the copied `conv_cost`, `block_cost`,
    `bound`); a residual block whose channels are multiples of 128 is one
    launch of A when `blocks`, else two of A0."""
    out = {"conv_int8": [0.0, 0], "block_int8": [0.0, 0]}

    def add(kind, nb, ops):
        out[kind][0] += costs.bound(nb, ops, costs.PEAK_INT8)[0] / 1e3
        out[kind][1] += 1

    by_block: dict[int, list] = {}
    for cv in convs:
        if cv["idx"] >= cut:
            break
        if cv["block"] is not None:
            by_block.setdefault(cv["block"][1], []).append(cv)
            continue
        hw = cv["hw_in"]
        add("conv_int8", *costs.conv_cost(batch, hw, hw, cv["cin"], cv["cout"], cv["k"],
                                          cv["stride"], False))
    for c1, c2 in by_block.values():
        hw = c1["hw_in"]
        if blocks and c1["cin"] % 128 == 0 and c1["cout"] % 128 == 0:
            add("block_int8", *costs.block_cost(batch, hw, hw, c1["cin"], c1["cout"]))
            continue
        for cv, skip in ((c1, False), (c2, True)):
            add("conv_int8", *costs.conv_cost(batch, hw, hw, cv["cin"], cv["cout"], cv["k"],
                                              1, skip))
    return out


def detect_int8_least(arch: dict, batch: int, tail: int, blocks: bool) -> dict:
    """`int8_launch_least` of one chunk's detect: the trunk's int8 walk up
    to its bf16 tail of `tail` blocks."""
    convs = costs.trunk_convs(arch)
    n_blocks = max(cv["block"][1] for cv in convs if cv["block"]) + 1
    cut = _first_conv_of_block(convs, n_blocks - tail) if tail else float("inf")
    return int8_launch_least(convs, batch, blocks, cut)


def add_least(total: dict, part: dict, times: int = 1) -> dict:
    for k, (s, n) in part.items():
        total.setdefault(k, [0.0, 0])
        total[k][0] += s * times
        total[k][1] += n * times
    return total


def upload_queue(ring, prefetch: int, device):
    """The program's upload queue (`data/pipeline.prefetch_batches`) over
    the ring's chunks, cycled: (an iterator of (chunk on the device, ring
    slot), its close function, which ends the upload thread)."""
    from face_vijnana_yolov3_tpu_torch.data.pipeline import prefetch_batches

    closed = {"flag": False}

    def make_batch(i):
        if closed["flag"]:
            raise _Closed
        return ring[i % len(ring)], i % len(ring)

    loaded = prefetch_batches(make_batch, 1 << 62, prefetch=prefetch, device=device)

    def close():
        closed["flag"] = True
        try:
            for _ in loaded:
                pass
        except _Closed:
            pass

    return loaded, close


def rows_of(cands: np.ndarray, counts: np.ndarray, geoms) -> list[np.ndarray]:
    """Each frame's rows [xmin, ymin, xmax, ymax, score] in its own
    coordinates, as `_iter_detection_chunks` builds them."""
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import unletterbox_boxes_chunk

    ub = unletterbox_boxes_chunk(cands, geoms)
    scores = cands[..., 5].astype(np.float64)
    return [np.concatenate([ub[k, :n], scores[k, :n, None]], axis=1)
            for k, n in enumerate(counts.tolist())]


def serve_loop(fd, ring, geoms, chunk: int, prefetch: int, device, spans):
    """A generator over served chunks, (ring slot, rows, taken, done), with
    its close function."""
    loaded, close = upload_queue(ring, prefetch, device)

    def chunks():
        while True:
            with spans.span("prefetch_wait"):
                staged, slot = next(loaded)
            taken = time.perf_counter()
            with spans.span("detect_batch_fused"):
                cands, counts = fd.detect_batch_fused(staged, geoms, pad_batch_to=chunk)
            with spans.span("unletterbox"):
                rows = rows_of(cands, counts, geoms)
            yield slot, rows, taken, time.perf_counter()

    return chunks(), close


def run(ctx) -> dict:
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_geometry

    arch, tp, cell, dev = ctx.config, ctx.traffic, ctx.cell, ctx.device
    precision, chunk = cell["precision"], tp["chunk"]
    sd = detector_state_dict(arch, ctx.seed, dev)
    frames, _faces = make_scenes(tp, ctx.seed, dev)
    ring = pinned_ring(frames, chunk)
    del frames
    h, w = tp["height"], tp["width"]
    geoms = [letterbox_geometry(h, w, arch["image_size"])] * chunk
    fd = build_detector(ctx, sd, precision)
    served, close = serve_loop(fd, ring, geoms, chunk, tp["prefetch"], dev, ctx.spans)
    for _ in range(cell["warmup_chunks"]):
        next(served)
    ctx.sync()
    window = []
    with profiled(ctx.trace) as prof:
        with ctx.spans.span("window"):
            t0 = time.perf_counter()
            for item in served:
                window.append(item)
                if item[3] - t0 >= ctx.seconds:
                    break
    t1 = window[-1][3]
    close()
    frames_done = len(window) * chunk
    e2e = {"img_s": frames_done / (t1 - t0), "setup_s": t0 - ctx.t_start}
    tail = int(getattr(fd, "int8_tail_chosen", 0) or 0)
    guard = int(fd._bf16_front_depth()) if precision == "bfloat16" else 0
    record = {"chunks": len(window), "frames": frames_done, "window_s": t1 - t0,
              "chunk_ms": [(d - t) * 1e3 for _, _, t, d in window],
              "serve_least_s_per_frame": serve_least_s(arch, precision, tail, guard, h, w),
              "host_s": sum(b - a for n, a, b in ctx.spans.items
                            if n == "unletterbox" and a >= t0)}
    if precision == "int8":
        blocks = bool(getattr(fd.conf, "int8_pallas_blocks", False))
        record["int8_least"] = add_least({}, detect_int8_least(arch, chunk, tail, blocks),
                                         len(window))
    tr = reduce_trace(prof, SPAN_NAMES) if prof is not None else None
    peak = ctx.memory_peak()
    del fd, served, close
    gc.collect()
    ctx.free()
    # The check: a sample of the window's chunks, drawn from the seed.
    rng = np.random.default_rng(ctx.seed + 7)
    picks = sorted(rng.choice(len(window), size=min(cell["check_chunks"], len(window)),
                              replace=False).tolist())
    t_ref = time.perf_counter()
    ref = Reference(ctx, sd, ring)
    want = ref.rows_of([window[i][0] for i in picks])
    prog = [r for i in picks for r in window[i][1]]
    ok, checks = verdict({"box_miss": box_miss(prog, want, net_pixel(ctx))}, cell["limits"])
    info = {"frames_compared": len(prog), "rows_program": sum(map(len, prog)),
            "rows_reference": sum(map(len, want)),
            "reference_s": time.perf_counter() - t_ref}
    if precision == "int8":
        info.update(program_tail=tail, reference_tail=ref.detector.tail)
    return dict(e2e=e2e, record=record, trace=tr, correct=ok, checks=checks, info=info,
                attempted=frames_done, failed=0, memory_peak_bytes=peak)


def net_pixel(ctx) -> float:
    """One pixel of the network's input in the frame's pixels."""
    return max(ctx.traffic["height"], ctx.traffic["width"]) / ctx.config["image_size"]


class Reference:
    """The plain reference serving the ring's chunks, at the cell's
    precision or, with `control`, at the one below (qmax 7, or fp8)."""

    def __init__(self, ctx, sd, ring, control: dict | None = None):
        control = control or {}
        cell = ctx.cell
        self.ring, self.device, self.cache = ring, ctx.device, {}
        self.detector = Detector(ctx.config, sd, cell["precision"],
                                 qmax=control.get("qmax", 127), fp8=control.get("fp8", False),
                                 bf16_f32_front=cell.get("conf", {}).get("bf16_f32_front", 2))
        if cell["precision"] == "int8":
            # The program calibrates on the first chunk it serves: slot 0.
            self.detector.calibrate(ring[0].to(ctx.device))

    def rows_of(self, slots: list[int]) -> list[np.ndarray]:
        out = []
        for slot in slots:
            if slot not in self.cache:
                self.cache[slot] = self.detector.rows(self.ring[slot].to(self.device))
            out += self.cache[slot]
        return out


def readings(ctx, control: dict) -> dict:
    """The control's numbers: the reference at the precision below the
    cell's put in the program's place, against the reference, on as many
    chunks of the ring as a run compares, drawn from the seed."""
    sd = detector_state_dict(ctx.config, ctx.seed, ctx.device)
    frames, _ = make_scenes(ctx.traffic, ctx.seed, ctx.device)
    ring = pinned_ring(frames, ctx.traffic["chunk"])
    del frames
    rng = np.random.default_rng(ctx.seed + 7)
    slots = rng.choice(len(ring), size=min(ctx.cell["check_chunks"], len(ring)),
                       replace=False).tolist()
    want = Reference(ctx, sd, ring).rows_of(slots)
    low = Reference(ctx, sd, ring, control).rows_of(slots)
    return {"box_miss": box_miss(low, want, net_pixel(ctx))}
