"""Spans around the calls into the program, and the reduction of a
torch.profiler trace of the window to the numbers the metric readers take.

The harness opens a span (`Spans.span`) around each call into a layer of
the program. Spans are kept in memory as host times; in a traced run each
is also a `record_function` range, so that the profiler puts it on the
same clock as the device's operations, and each idle gap of the device can
be named by what the host was doing in it.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

from fvy_bench.harness.costs import category

WINDOW_SPAN = "window"
# Spans nest at most this deep: the look back for a covering span stops there.
MAX_NESTING = 4


class Spans:
    """Host spans (name, start s, end s) of one run, in memory."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.items: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.traced:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.items.append((name, t0, time.perf_counter()))


@contextlib.contextmanager
def profiled(enabled: bool):
    """torch.profiler over the block (CPU and CUDA activity) when enabled;
    yields the profiler, or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def _ns(ev, which: str) -> int:
    return int(getattr(ev, f"{which}_ns")())


def reduce_trace(prof, span_names: tuple[str, ...]) -> dict:
    """The traced window's device numbers: window_s (the `window` span),
    busy_s (the union of the device's operations inside it), device_s by
    `category`, h2d_s (host-to-device copies), kernel_s by kernel name, and
    the idle gaps of the window named by the innermost of `span_names`
    that covers each gap's middle ("outside_any_span" where none does)."""
    events = prof.profiler.kineto_results.events()
    cpu_spans, dev = [], []
    for ev in events:
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation():
                dev.append((_ns(ev, "start"), _ns(ev, "end"), ev.name()))
        elif ev.name() in span_names or ev.name() == WINDOW_SPAN:
            cpu_spans.append((_ns(ev, "start"), _ns(ev, "end"), ev.name()))
    windows = [(a, b) for a, b, n in cpu_spans if n == WINDOW_SPAN]
    if not windows:
        raise RuntimeError("trace: no window span")
    w0, w1 = windows[0]
    dev = sorted((max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1)
    device_s: dict[str, float] = defaultdict(float)
    kernel_s: dict[str, float] = defaultdict(float)
    kernel_n: dict[str, int] = defaultdict(int)
    h2d = 0.0
    busy, end = 0, w0
    gaps: list[tuple[int, int]] = []
    for a, b, n in dev:
        dt = (b - a) / 1e9
        device_s[category(n)] += dt
        kernel_s[n] += dt
        kernel_n[n] += 1
        if "HtoD" in n:
            h2d += dt
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    spans = sorted((a, b, n) for a, b, n in cpu_spans if n != WINDOW_SPAN)
    starts = [a for a, _, _ in spans]
    idle: dict[str, float] = defaultdict(float)
    for a, b in gaps:
        # The latest-starting span that covers the gap's middle: the
        # innermost one, since the harness's spans nest or follow each other.
        mid, name = (a + b) // 2, "outside_any_span"
        last = bisect.bisect_right(starts, mid) - 1
        for i in range(last, max(last - MAX_NESTING, -1), -1):
            if spans[i][1] >= mid:
                name = spans[i][2]
                break
        idle[name] += (b - a) / 1e9
    return dict(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, device_s=dict(device_s),
                kernel_s=dict(kernel_s), kernel_n=dict(kernel_n), h2d_s=h2d,
                idle_s=dict(idle))


def breakdown(tr: dict) -> dict:
    """The result line's `breakdown`: the device operations by category and
    the idle gaps by span, the ten largest of each, in seconds."""
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(tr["device_s"]), "idle_gaps": top(tr["idle_s"])}
