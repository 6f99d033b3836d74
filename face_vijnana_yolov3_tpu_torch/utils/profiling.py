"""Tracing and profiling of the port: spans of the program's own work in
memory, a torch.profiler trace, and the reference's elapsed-time prints.

Port of face_vijnana_yolov3_tpu/utils/profiling.py, with the port's one
tracer added.

`span(name, request=None, **attrs)` marks a piece of the program's work
(the sites and their names: PERF.md §3); `spanned(name, **attrs)` is the
same as a decorator of a whole function. Spans are off by default: a span
site then reads one flag and enters one shared no-op context, which
allocates and records nothing. Spans are on after `enable(True)`, and
inside `device_trace`, so that an operator's trace holds the program's
spans above its kernels; another torch.profiler leaves them as they are. A
span that is on enters `torch.profiler.record_function(name)` while a
profiler records (outside one the range would go nowhere, at half a span's
cost) and, when it ends, appends a `Span` to an in-memory buffer of
MAX_SPANS, the oldest dropped first:

- `start_ns`, `end_ns` on the clock of the profiler's events (kineto's
  `start_ns()`, Unix time in ns): `time.perf_counter_ns()` plus the offset
  to `time.time_ns()` read when the module loads and at each `enable(True)`,
  so the spans of any thread, the upload thread's included, line up with
  the device's kernels and copies without a conversion
  (tests/test_torch_tracing.py holds a span to its profiler range);
- `thread`, the OS thread id; `parent`, the name of the enclosing span on
  the same thread (None at the top);
- `request`, the chunk or step the span serves: the argument, else the
  thread's current request (`set_request`; `data/pipeline.prefetch_batches`
  sets the consumer's to i as it takes batch i off its queue, and the
  upload of batch i carries i), so that a chunk's upload, detect, fetch
  and rows share one id;
- `attrs`, the keyword arguments, and what the block adds with
  `set_attrs` (to the innermost open span of its thread).

`spans()` copies the buffer out, `reset()` empties it. `stage_timer`
synchronises the CUDA card (when one is in use) before each clock read, so
the time covers the work queued inside the block, and prints the
reference's line; `device_trace` writes a Chrome trace of CPU and CUDA
activity into `logdir`; `annotate` is `span`.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import threading
import time

import torch
import torch.autograd.profiler as _torch_profiler

MAX_SPANS = 1 << 17  # ~25 MB of spans; a traced 30 s window holds < 10,000

Span = collections.namedtuple(
    "Span", "name thread start_ns end_ns parent request attrs")

_on = False
_buffer: collections.deque = collections.deque(maxlen=MAX_SPANS)
_lock = threading.Lock()  # copying the buffer out races the appends
_local = threading.local()  # per thread: the open spans, the request


def _clock_offset() -> int:
    """time.time_ns() - time.perf_counter_ns(), from the closest of a few
    back-to-back reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


_offset_ns = _clock_offset()


def enable(on: bool = True) -> None:
    """Turn the program's spans on or off (off by default)."""
    global _on, _offset_ns
    if on:
        _offset_ns = _clock_offset()
    _on = bool(on)


def spans() -> list:
    """The spans recorded so far, in the order they ended."""
    with _lock:
        return list(_buffer)


def reset() -> None:
    """Drop every span recorded."""
    with _lock:
        _buffer.clear()


def set_request(request) -> None:
    """Make `request` the current request of this thread's spans."""
    _local.request = request


def set_attrs(**attrs) -> None:
    """Add attributes to this thread's innermost open span (none while
    spans are off)."""
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1].attrs.update(attrs)


class _NoSpan:
    """The context every span site enters while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "request", "attrs", "_parent", "_start", "_range")

    def __init__(self, name: str, request, attrs: dict):
        self.name, self.request, self.attrs = name, request, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._parent = stack[-1].name if stack else None
        stack.append(self)
        self._range = None
        if _torch_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _local.stack.pop()
        request = self.request
        if request is None:
            request = getattr(_local, "request", None)
        item = Span(self.name, threading.get_native_id(), self._start + _offset_ns,
                    end + _offset_ns, self._parent, request, self.attrs)
        with _lock:
            _buffer.append(item)
        return False


def span(name: str, request=None, **attrs):
    """A context over a piece of the program's work (module docstring)."""
    if not _on:
        return _NO_SPAN
    return _Span(name, request, attrs)


def spanned(name: str, **attrs):
    """Decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, **attrs):
                return fn(*args, **kwargs)
        return call
    return wrap


annotate = span


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def stage_timer(name: str, *, out: list | None = None):
    """Coarse stage timing with the reference's elapsed-time print UX."""
    _sync()
    ts = time.time()
    yield
    _sync()
    te = time.time()
    print("Elasped time: {0:f}s".format(te - ts))  # reference spelling
    if out is not None:
        out.append((name, te - ts))


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace around a block (CPU, and CUDA when a card is in
    use), written to `logdir/trace.json` for chrome://tracing or Perfetto,
    with the program's spans on inside it; yields the profiler (its
    `key_averages()` sums time by kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was_on = _on
    enable(True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
            _sync()
    finally:
        enable(was_on)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
