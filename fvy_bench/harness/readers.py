"""The arithmetic of the per-layer metrics, one function a quantity; each
metric's file under metrics/ names the function it reads with, so that a
quantity split by the end-to-end metric its cells report (`.serve`,
`.identify`, `.train`) keeps one definition."""

from __future__ import annotations

import numpy as np

from fvy_bench.harness.costs import category


def idle_share(run: dict):
    """Share of the traced window in which no kernel or copy ran on the
    card (torch.profiler), in %."""
    tr = run["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def serve_mfu(run: dict):
    """The whole serving step's share of the H100's published dense peaks,
    in %: the least time of the frames served in the traced window (the
    driver's `serve_least_s_per_frame`: each frame's letterbox GEMMs at the
    f32 peak, its convs at the peak of the precision each runs in, its
    crops' GEMMs, embeds and dense1 for identify), over the window's
    seconds."""
    rec = run["record"]
    least = rec.get("serve_least_s_per_frame")
    if least is None or not rec.get("frames"):
        return None
    return 100.0 * least * rec["frames"] / rec["window_s"]


def chunk_p95_ms(run: dict):
    """The 95th percentile, over every chunk of the traced window, of a
    chunk's time through the serving step: from when the loop takes it off
    the upload queue to its rows on the host (the harness's clock around
    the calls into the program), in ms. The loop is closed and at the
    card's capacity, where a tail swings with the smallest change: it
    stands beside the rate, not as an end-to-end metric."""
    lat = run["record"].get("chunk_ms")
    if not lat:
        return None
    return float(np.percentile(lat, 95))


def upload_ms(run: dict):
    """Device time of the host-to-device copies per served chunk in the
    traced window (torch.profiler), in ms."""
    tr, rec = run["trace"], run["record"]
    if tr is None or not rec.get("chunks"):
        return None
    return 1e3 * tr["h2d_s"] / rec["chunks"]


def host_ms(run: dict):
    """Host time per served chunk between the program's return and the
    chunk's rows (the harness's `unletterbox` span around
    `unletterbox_boxes_chunk` and the rows) and, for identify, in the ROI
    plan (`roi_plan`), in ms."""
    rec = run["record"]
    if not rec.get("chunks") or rec.get("host_s") is None:
        return None
    return 1e3 * rec["host_s"] / rec["chunks"]


def int8_roofline(run: dict):
    """Kernels A (block_int8) and A0 (conv_int8) against their roofline, in
    %: the least time of their launches in the traced window (each launch's
    bytes and int8 operations from its shapes: the driver's `int8_least`,
    per kind the least seconds and the launch count of the window's work),
    over their summed device time. Where the trace holds another number of
    launches of a kind than the work makes (a launch cut by the window's
    edge), the least time scales with the traced count."""
    tr, least = run["trace"], run["record"].get("int8_least")
    if tr is None or not least:
        return None
    total_least = total_time = 0.0
    for kind, (seconds, launches) in least.items():
        traced = sum(n for name, n in tr["kernel_n"].items() if category(name) == kind)
        if launches:
            total_least += seconds * traced / launches
        total_time += tr["device_s"].get(kind, 0.0)
    if total_time <= 0:
        return None
    return 100.0 * total_least / total_time
