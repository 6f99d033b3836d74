"""Host→device input pipeline: threaded prefetch and upload.

Port of face_vijnana_yolov3_tpu/data/pipeline.py:19-60. One worker thread
assembles batches ahead of the consumer (JPEG decode and cv2 release the
GIL); with a `device`, the worker also starts each batch's tensors on their
way to it: from pinned memory, `non_blocking`, so the worker does not wait
for the copy. The copy is enqueued on the worker's current stream, which is
the card's default stream, the stream the consumer's programs replay on:
on the card it runs between their kernels, not beside them. The span
`fvy.upload` covers the assembly and the enqueue; the share of the copies'
device time during which a kernel ran is `upload_overlap` of
fvy_bench/harness/program.py (PERF.md §5).
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Callable, Iterator

import torch

from face_vijnana_yolov3_tpu_torch.utils import profiling


def _to_device(batch: tuple, device: torch.device) -> tuple:
    """Move the torch tensors at the top level of a batch tuple to `device`."""

    def move(x):
        if not isinstance(x, torch.Tensor):
            return x
        if device.type == "cuda":
            x = x.pin_memory()
        return x.to(device, non_blocking=True)

    return tuple(move(x) for x in batch)


def prefetch_batches(
    make_batch: Callable[[int], tuple],
    num_batches: int,
    *,
    prefetch: int = 2,
    device: torch.device | str | None = None,
) -> Iterator[tuple]:
    """Yield `make_batch(i)` for i in range(num_batches), produced ahead of time.

    A single worker thread keeps up to `prefetch` batches queued. Worker
    exceptions are re-raised in the consumer: swallowing them would make a
    failed run (corrupt image, bad CSV row) look like a short one. Spans
    (utils/profiling): the worker's `fvy.upload` (make_batch(i) and the
    upload's enqueue) and `fvy.upload.full` (blocked on a full queue), both
    of request i; the consumer's `fvy.prefetch.wait` (blocked on an empty
    queue), after which its spans serve request i until the next batch.
    """
    dev = torch.device(device) if device is not None else None
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = object()

    def worker():
        try:
            for i in range(num_batches):
                with profiling.span("fvy.upload", request=i):
                    batch = make_batch(i)
                    if dev is not None:
                        batch = _to_device(batch, dev)
                with profiling.span("fvy.upload.full", request=i):
                    q.put(batch)
            q.put(stop)
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        for i in itertools.count():
            with profiling.span("fvy.prefetch.wait"):
                item = q.get()
                profiling.set_request(i)
            if item is stop:
                break
            if isinstance(item, BaseException):
                t.join()
                raise item
            yield item
    finally:
        profiling.set_request(None)
    t.join()
