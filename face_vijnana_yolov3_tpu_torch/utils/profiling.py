"""Tracing and profiling helpers: the reference's elapsed-time prints, a
`torch.profiler` trace, and named ranges inside it.

Port of face_vijnana_yolov3_tpu/utils/profiling.py. `stage_timer`
synchronises the CUDA card (when one is in use) before each clock read, so
the time covers the work queued inside the block; `device_trace` writes a
Chrome trace of CPU and CUDA activity into `logdir`; `annotate` is a
`torch.profiler.record_function` range.

Nothing in the package calls these, as nothing in the JAX package calls
its own: they are kept for a user who wraps a run in them. chip_smoke.py
profiles with CUDA activity alone.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


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
    use), written to `logdir/trace.json` for chrome://tracing or Perfetto;
    yields the profiler (its `key_averages()` sums time by kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace."""
    with torch.profiler.record_function(name):
        yield
