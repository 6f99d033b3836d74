"""The readers of the program's spans and its caches' counters
(fvy_bench/harness/program.py) on made-up spans and traces, and its report
on tiny runs of the benchmark's cells on the CPU; run.py's traced run
records no program span."""

import pytest

from face_vijnana_yolov3_tpu_torch.utils import profiling
from face_vijnana_yolov3_tpu_torch.utils.profiling import Span
from fvy_bench import run
from fvy_bench.harness import program
from fvy_bench.tests.test_fvy_bench_rehearsal import TINY_IDENTIFY, TINY_STREAM, TINY_TRAIN

HTOD = program.UPLOAD_COPY
PAGEABLE = "Memcpy HtoD (Pageable -> Device)"
MAIN, WORKER = 11, 22


def _span(name, a, b, thread=MAIN, parent=None, request=None, **attrs):
    return Span(name, thread, a, b, parent, request, attrs)


# The window [1000, 2000) ns: a kernel in [1100, 1300); pinned copies whose
# calls the host made inside the upload thread's `fvy.upload` span [1140,
# 1180] (1) and before (2) and after it (3); a pageable copy of the serving
# thread called while the upload span was open (5).
EVENTS = {
    "window": (1000, 2000),
    "device": [(1100, 1300, "gemm_kernel", 9), (1200, 1400, HTOD, 1),
               (1250, 1290, PAGEABLE, 5), (1500, 1600, HTOD, 2), (1650, 1700, HTOD, 3),
               (1700, 1750, "Memcpy DtoH (Device -> Pinned)", 4)],
    "calls": [(1150, 1), (1160, 5), (1130, 2), (1190, 3)],
}
SPANS = [
    _span("fvy.pipeline.init", 100, 300),
    _span("fvy.calibrate_int8", 300, 700),
    _span("fvy.program.build", 700, 800, key=("fused",)),
    _span("fvy.program.build", 850, 900, key=("roi", 64)),
    _span("fvy.upload.full", 200, 900, thread=WORKER),
    _span("fvy.upload", 1140, 1180, thread=WORKER, request=0),
    _span("fvy.upload.full", 1180, 1240, thread=WORKER, request=0),
    _span("fvy.program.replay", 1050, 1100, request=0, key="fused"),
    _span("fvy.roi.plan", 1300, 1500, request=0),
    _span("fvy.roi.taps", 1320, 1480, parent="fvy.roi.plan", request=0),
    _span("fvy.roi.pack", 1500, 1510, request=0),
    _span("fvy.program.replay", 1850, 1900, request=1, key="roi"),
]


def test_upload_overlap_reads_the_programs_uploads():
    """The upload copy that overlaps a kernel for half its time reads
    50 %; the pinned copies called outside `fvy.upload` are left out."""
    assert program.upload_overlap(EVENTS, SPANS) == pytest.approx(50.0)
    outside = dict(EVENTS, calls=[(1130, 2), (1190, 3), (1160, 5)])
    assert program.upload_overlap(outside, SPANS) is None
    assert program.upload_overlap(EVENTS, []) is None


def test_a_pageable_copy_beside_an_upload_is_left_out():
    """The serving thread's pageable copy (the ROI operands), called while
    the upload thread's span was open and overlapping the kernel, is no
    upload: the reading stays 50 %. Were it pinned, it would count."""
    assert program.upload_overlap(EVENTS, SPANS) == pytest.approx(50.0)
    pinned = dict(EVENTS, device=[(a, b, HTOD if n == PAGEABLE else n, c)
                                  for a, b, n, c in EVENTS["device"]])
    assert program.upload_overlap(pinned, SPANS) == pytest.approx(100 * 140 / 240)


def test_idle_gaps_are_named_by_the_innermost_program_span():
    gaps = program.idle_gaps_program(EVENTS, SPANS, MAIN)
    # Idle: [1000, 1100) and [1750, 2000) in replays, [1400, 1500) in the
    # plan's tap tables, [1600, 1650) outside.
    assert gaps == pytest.approx({"fvy.program.replay": 350e-9, "fvy.roi.taps": 100e-9,
                                  "outside_any_span": 50e-9})


def test_setup_builds_and_replays():
    assert program.setup_spans(EVENTS, SPANS, MAIN) == pytest.approx(
        {"fvy.calibrate_int8": 400e-9, "fvy.pipeline.init": 200e-9,
         "fvy.program.build": 150e-9})
    nums = program.program_numbers(EVENTS, SPANS, 2, MAIN, {"builds": 0, "replays": 3})
    assert nums["builds_in_window"] == 0 and nums["replays_per_chunk"] == 1.5
    nums = program.program_numbers(EVENTS, SPANS, 2, MAIN, None)
    assert nums["builds_in_window"] is None and nums["replays_per_chunk"] is None


def test_the_caches_counters_are_read_between_two_points():
    """Builds and replays come from the ProgramCache counters, as the
    difference between the window's start and end; a cache made in
    between counts from 0."""
    import torch

    from face_vijnana_yolov3_tpu_torch.core.programs import ProgramCache

    old = ProgramCache("cpu")
    old.run(("k",), lambda t: t + 1.0, torch.zeros(2))
    before = program.cache_counts()
    assert before[id(old)] == (1, 0)
    old.run(("k",), lambda t: t + 1.0, torch.zeros(2))
    new = ProgramCache("cpu")
    for _ in range(3):
        new.run(("j",), lambda t: t * 2.0, torch.zeros(2))
    assert program.counted_between(before, program.cache_counts()) == {
        "builds": 1, "replays": 3}
    assert program.counted_between(None, before) is None


@pytest.mark.parametrize("name,metric,want", [
    ("fvy.program.build", "build_s", 150e-9),
    ("fvy.calibrate_int8", "calibrate_s", 400e-9),
    ("fvy.embed", None, None),
])
def test_seconds_before_the_window(name, metric, want):
    got = program.seconds_before(EVENTS, SPANS, name)
    assert got == (None if want is None else pytest.approx(want))
    if metric:
        assert program.program_numbers(EVENTS, SPANS, 2, MAIN, None)[metric] == got


def test_roi_plan_ms_reads_the_plans_in_the_window():
    """The plans that start in the window, per chunk; a plan before it (at
    set-up) is left out, and one that outlasts the window counts up to its
    end."""
    plans = [_span("fvy.roi.plan", 500, 900), _span("fvy.roi.plan", 1000, 1400),
             _span("fvy.roi.plan", 1500, 1900), _span("fvy.roi.plan", 1950, 9000)]
    events = {"window": (1000, 2000), "device": [], "calls": []}
    assert program.ms_per_chunk(events, plans, "fvy.roi.plan", 2) == pytest.approx(850 / 2e6)
    assert program.program_numbers(events, plans, 4, MAIN, None)["roi_plan_ms"] == (
        pytest.approx(850 / 4e6))
    assert program.ms_per_chunk(events, plans[:1], "fvy.roi.plan", 2) is None


def test_the_upload_thread_is_read_by_span():
    """The upload thread's ms a chunk in its work and in its wait on a full
    queue, from the spans that start in the window; the last wait, which
    lasts past the window until the loop drains the queue, is cut at the
    window's end."""
    last = _span("fvy.upload.full", 1950, 50_000, thread=WORKER, request=1)
    nums = program.program_numbers(EVENTS, SPANS + [last], 2, MAIN, None)
    assert nums["upload_thread_ms"] == pytest.approx(
        {"fvy.upload": 40 / 2e6, "fvy.upload.full": 110 / 2e6})


@pytest.fixture
def tiny_front(monkeypatch):
    from fvy_bench.drivers import identify

    front = identify.front_detector
    monkeypatch.setattr(identify, "front_detector", lambda ctx: dict(front(ctx), image_size=64))


def test_a_traced_run_records_no_program_span():
    """run.py's traced run leaves the program's spans off: its profiler
    does not turn them on, so the parent's and the change's traced runs do
    the same work."""
    profiling.reset()
    res = run.execute("fd_bf16_stream_b40", 2**31 + 4321, 0.5, True, "cpu", TINY_STREAM)
    assert res["correct"] and res["metrics"]["host_ms.serve"]["value"] > 0
    assert profiling.spans() == [] and not profiling._on


@pytest.mark.parametrize("workload,tiny,calibrates", [
    ("fd_int8_stream_b40", TINY_STREAM, True),
    ("fi_int8_identify_b40", TINY_IDENTIFY, True),
    ("fd_bf16_stream_b40", TINY_STREAM, False),
    ("fd_train_f32_b40", TINY_TRAIN, False),
])
def test_the_report_splits_setup_and_names_the_gaps(tiny_front, workload, tiny, calibrates):
    res = program.report(run, workload, 2**31 + 777, 0.5, True, True, "cpu", tiny)
    nums = res["program"]
    assert res["correct"] and nums["build_s"] > 0 and nums["builds_in_window"] == 0
    assert (nums["calibrate_s"] is not None) == calibrates
    assert nums["replays_per_chunk"] >= 1
    uploads = nums["upload_thread_ms"]["fvy.upload"]
    assert (uploads is not None) == (workload != "fd_train_f32_b40")
    assert "fvy.program.build" in nums["setup_spans"]
    assert sum(nums["idle_gaps_program"].values()) > 0
    assert (nums["roi_plan_ms"] is not None) == workload.startswith("fi_")
    assert not profiling._on


def test_the_report_measures_without_a_trace(tiny_front):
    res = program.report(run, "fd_bf16_stream_b40", 2**31 + 778, 0.5, False, True, "cpu",
                         TINY_STREAM)
    assert "program" not in res and res["metrics"]["img_s"]["value"] > 0
