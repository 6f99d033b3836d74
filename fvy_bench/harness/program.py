"""The program's own spans (face_vijnana_yolov3_tpu_torch/utils/profiling)
and its program caches' counters, read beside the traced window: the
numbers of the program's layers, and the report that runs one cell with
the program's spans on.

The program's spans carry the clock of the profiler's events, so they line
up with the window and with the device's kernels and copies as they are.
They are off unless something turns them on: a run of run.py records
none, traced or not. The report turns them on for the whole run:

    python3 -m fvy_bench.harness.program --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> --spans <0|1>

runs the cell once, as run.py does, with the program's spans on or off
(`--spans`; with `--trace 0` the end-to-end line with spans on measures
what they cost), and with `--trace 1` adds to the result line `program`:
the window's idle gaps named by the program's spans, the seconds of
set-up by top-level span, the program builds in the window and the
replays a chunk (from the caches' counters), `build_s`, `calibrate_s`,
`roi_plan_ms`, the upload thread's ms a chunk by span, and
`upload_overlap`.

A program without the spans or the counters (one older than them) gives
the readers here nothing to read: each returns None.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import json
import sys
import threading
from collections import defaultdict

WINDOW_SPAN = "window"  # the harness's span around the window (harness/trace.py)
# The device operation of the upload's copy from the pinned batch.
UPLOAD_COPY = "Memcpy HtoD (Pinned -> Device)"
# Spans of one thread that may start between a gap's middle and the span
# covering it (a parent's earlier children: the ROI pieces' replays).
LOOK_BACK = 64


def cache_counts() -> dict | None:
    """(builds, replays) of each live ProgramCache of the program, by id,
    or None where the caches count neither."""
    from face_vijnana_yolov3_tpu_torch.core.programs import ProgramCache

    caches = [o for o in gc.get_objects() if type(o) is ProgramCache]
    if any(not hasattr(c, "builds") for c in caches):
        return None
    return {id(c): (c.builds, c.replays) for c in caches}


def counted_between(before: dict | None, after: dict | None) -> dict | None:
    """The builds and replays counted between two `cache_counts` (a cache
    made in between counts from 0)."""
    if before is None or after is None:
        return None
    diff = [(b - before.get(k, (0, 0))[0], r - before.get(k, (0, 0))[1])
            for k, (b, r) in after.items()]
    return {"builds": sum(d[0] for d in diff), "replays": sum(d[1] for d in diff)}


def raw_events(prof) -> dict:
    """From a torch.profiler trace: the window (start, end ns), the
    device's operations [(start, end, name, correlation)] and the host's
    CUDA memcpy calls [(start, correlation)]."""
    import torch

    window, device, calls = None, [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append((ev.start_ns(), ev.end_ns(), ev.name(), ev.correlation_id()))
        elif ev.name() == WINDOW_SPAN and window is None:
            window = (ev.start_ns(), ev.end_ns())
        elif ev.name().startswith("cudaMemcpy"):
            calls.append((ev.start_ns(), ev.correlation_id()))
    if window is None:
        raise RuntimeError("trace: no window span")
    return {"window": window, "device": device, "calls": calls}


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _union(intervals) -> list[tuple[int, int]]:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _covered(a: int, b: int, union: list[tuple[int, int]], starts: list[int]) -> int:
    """ns of [a, b) inside the disjoint sorted `union`."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    got = 0
    while i < len(union) and union[i][0] < b:
        got += max(0, min(b, union[i][1]) - max(a, union[i][0]))
        i += 1
    return got


def upload_overlap(events: dict, spans) -> float | None:
    """Of the device time in the window of the upload's copies, the share
    during which a kernel ran, in %. An upload copy is a pinned host to
    device copy (`UPLOAD_COPY`) whose CUDA call the host made inside a
    `fvy.upload` span: the trace's thread ids of memcpy calls are not the
    OS's (on torch 2.11 every call reads thread 1), so the call's time and
    the copy's kind decide. The serving thread's own uploads are pageable
    (`fvy.roi.pack`) and stay out, whenever their calls fall."""
    w0, w1 = events["window"]
    uploads = _union((s.start_ns, s.end_ns) for s in spans if s.name == "fvy.upload")
    up_starts = [a for a, _ in uploads]
    called = {corr for t, corr in events["calls"] if _covered(t, t + 1, uploads, up_starts)}
    kernels = _union((max(a, w0), min(b, w1)) for a, b, n, _ in events["device"]
                     if _is_kernel(n) and b > w0 and a < w1)
    starts = [a for a, _ in kernels]
    total = over = 0
    for a, b, n, corr in events["device"]:
        if n == UPLOAD_COPY and corr in called and b > w0 and a < w1:
            a, b = max(a, w0), min(b, w1)
            total += b - a
            over += _covered(a, b, kernels, starts)
    return 100.0 * over / total if total else None


def idle_gaps_program(events: dict, spans, thread: int) -> dict[str, float]:
    """The window's idle gaps of the device (no kernel or copy) in s, each
    named by the innermost program span of `thread` (the serving loop's)
    that covers its middle ("outside_any_span" where none does)."""
    w0, w1 = events["window"]
    busy = _union((max(a, w0), min(b, w1)) for a, b, *_ in events["device"]
                  if b > w0 and a < w1)
    gaps, end = [], w0
    for a, b in busy:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    mine = sorted((s.start_ns, s.end_ns, s.name) for s in spans
                  if s.thread == thread and s.end_ns > w0 and s.start_ns < w1)
    starts = [a for a, _, _ in mine]
    idle: dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid, name = (a + b) // 2, "outside_any_span"
        # The latest-starting span that covers the middle: spans of one
        # thread nest or follow each other, so the look back stops at the
        # first that covers it, or after the siblings a parent can hold.
        last = bisect.bisect_right(starts, mid) - 1
        for i in range(last, max(last - LOOK_BACK, -1), -1):
            if mine[i][1] >= mid:
                name = mine[i][2]
                break
        idle[name] += (b - a) / 1e9
    return dict(sorted(idle.items(), key=lambda kv: -kv[1]))


def setup_spans(events: dict, spans, thread: int) -> dict[str, float]:
    """Seconds before the window of each top-level program span of
    `thread` (the one that sets up and serves), by name."""
    w0 = events["window"][0]
    out: dict[str, float] = defaultdict(float)
    for s in spans:
        if s.thread == thread and s.parent is None and s.start_ns < w0:
            out[s.name] += (min(s.end_ns, w0) - s.start_ns) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def seconds_before(events: dict, spans, name: str) -> float | None:
    """Seconds in the spans `name` before the window (None without any)."""
    w0 = events["window"][0]
    got = [min(s.end_ns, w0) - s.start_ns for s in spans
           if s.name == name and s.start_ns < w0]
    return sum(got) / 1e9 if got else None


def ms_per_chunk(events: dict, spans, name: str, chunks: int) -> float | None:
    """Host ms a chunk in the spans `name` that start in the window, cut at
    its end (None without any): the upload thread's last wait on a full
    queue lasts until the loop drains it, after the profiler has stopped."""
    w0, w1 = events["window"]
    got = [min(s.end_ns, w1) - s.start_ns for s in spans
           if s.name == name and w0 <= s.start_ns < w1]
    return sum(got) / 1e6 / chunks if got else None


def program_numbers(events: dict, spans, chunks: int, thread: int,
                    counted: dict | None) -> dict:
    """The report's `program`: what the program's spans and its caches'
    counters (`counted`, between the window's start and end) say of one
    traced run of `chunks` chunks or steps, served from `thread`."""
    return {"idle_gaps_program": idle_gaps_program(events, spans, thread),
            "setup_spans": setup_spans(events, spans, thread),
            "builds_in_window": None if counted is None else counted["builds"],
            "replays_per_chunk": None if counted is None else counted["replays"] / chunks,
            "build_s": seconds_before(events, spans, "fvy.program.build"),
            "calibrate_s": seconds_before(events, spans, "fvy.calibrate_int8"),
            "roi_plan_ms": ms_per_chunk(events, spans, "fvy.roi.plan", chunks),
            "upload_thread_ms": {n: ms_per_chunk(events, spans, n, chunks)
                                 for n in ("fvy.upload", "fvy.upload.full")},
            "upload_overlap": upload_overlap(events, spans)}


def report(run, workload: str, seed: int, seconds: float, trace: bool, spans_on: bool,
           device, overrides: dict | None = None) -> dict:
    """One run of a cell through `run.execute` with the program's spans on
    or off; with `trace`, its result line gains `program`."""
    from face_vijnana_yolov3_tpu_torch.utils import profiling

    drv = run.driver(run.cell_files(workload)[4])
    kept = {}
    drive, reduce, profiled = drv.run, drv.reduce_trace, drv.profiled

    def keep_record(ctx):
        out = drive(ctx)
        kept["record"] = out["record"]
        return out

    def keep_events(prof, names):
        kept["events"] = raw_events(prof)
        return reduce(prof, names)

    @contextlib.contextmanager
    def counting(enabled):
        # The drivers' profiler covers the window and nothing else.
        before = cache_counts()
        with profiled(enabled) as prof:
            yield prof
        kept["counted"] = counted_between(before, cache_counts())

    profiling.reset()
    profiling.enable(spans_on)
    drv.run, drv.reduce_trace, drv.profiled = keep_record, keep_events, counting
    try:
        result = run.execute(workload, seed, seconds, trace, device, overrides)
    finally:
        drv.run, drv.reduce_trace, drv.profiled = drive, reduce, profiled
        profiling.enable(False)
    if trace:
        # Chunks served, or training steps (the training driver attempts steps).
        chunks = kept["record"].get("chunks") or result["attempted"]
        result["program"] = program_numbers(kept["events"], profiling.spans(), chunks,
                                            threading.main_thread().native_id,
                                            kept["counted"])
    return result


def main(argv=None) -> int:
    from fvy_bench import run  # first: it fixes the CPU threads before torch loads

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    if not run.torch.cuda.is_available():
        print("program.py: no CUDA card", file=sys.stderr)
        return 2
    run.torch.set_num_threads(run.THREADS)
    run.bind_to_card(0)
    result = report(run, args.workload, args.seed, args.seconds, bool(args.trace),
                    bool(args.spans), "cuda")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
