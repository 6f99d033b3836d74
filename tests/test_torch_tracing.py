"""The port's tracer (utils/profiling.py) and its span sites, on the CPU:
spans off cost one shared no-op; spans on nest, carry their thread and
the request they serve, and sit on the clock of the profiler's events;
ProgramCache counts its builds and replays; the fused int8 detect and the
device identify chunk emit their spans in order."""

import threading

import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu_torch.api import face_detection as port_fd
from face_vijnana_yolov3_tpu_torch.api import face_identification as port_fi
from face_vijnana_yolov3_tpu_torch.api.config import Conf, FdConf
from face_vijnana_yolov3_tpu_torch.core.programs import ProgramCache
from face_vijnana_yolov3_tpu_torch.data.pipeline import prefetch_batches
from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_geometry
from face_vijnana_yolov3_tpu_torch.utils import profiling
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)
port_fd.DEBUG = False
port_fi.DEBUG = False

S = 64


@pytest.fixture
def spans_on():
    profiling.reset()
    profiling.enable(True)
    yield
    profiling.enable(False)
    profiling.reset()


def _top(spans):
    """Names of this thread's top-level spans, by start."""
    me = threading.get_native_id()
    return [s.name for s in sorted(spans, key=lambda s: s.start_ns)
            if s.parent is None and s.thread == me]


def test_spans_off_are_one_shared_noop():
    profiling.enable(False)
    profiling.reset()
    a, b = profiling.span("a"), profiling.span("b", request=3, key=(1,))
    assert a is b
    with a:
        profiling.set_attrs(x=1)
    batches = list(prefetch_batches(lambda i: (torch.zeros(2) + i,), 3, prefetch=1))
    cache = ProgramCache("cpu")
    cache.run(("k",), lambda t: t + 1.0, torch.zeros(2))
    assert len(batches) == 3 and profiling.spans() == []


def test_spans_nest_and_carry_thread_and_request(spans_on):
    @profiling.spanned("decorated", c=3)
    def work(x):
        """Doubles x."""
        with profiling.span("inner"):
            return 2 * x

    with profiling.span("outer", a=1):
        assert work(4) == 8
        profiling.set_attrs(b=2)
    got = {s.name: s for s in profiling.spans()}
    assert got["inner"].parent == "decorated" and got["decorated"].parent == "outer"
    assert got["outer"].parent is None
    assert got["outer"].attrs == {"a": 1, "b": 2} and got["decorated"].attrs == {"c": 3}
    assert work.__name__ == "work" and work.__doc__ == "Doubles x."
    assert got["inner"].start_ns >= got["outer"].start_ns
    assert got["inner"].end_ns <= got["outer"].end_ns
    assert got["outer"].thread == threading.get_native_id()

    profiling.reset()
    for i, (x,) in enumerate(prefetch_batches(lambda i: (torch.full((2,), float(i)),), 3,
                                              prefetch=1)):
        assert float(x[0]) == i
        with profiling.span("consume"):
            pass
    spans = profiling.spans()
    me = threading.get_native_id()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    assert sorted(s.request for s in by["fvy.upload"]) == [0, 1, 2]
    assert sorted(s.request for s in by["fvy.upload.full"]) == [0, 1, 2]
    assert sorted(s.request for s in by["consume"]) == [0, 1, 2]
    # The waits for batches 0-2, then the one that takes the end off the queue.
    assert [s.request for s in by["fvy.prefetch.wait"]] == [0, 1, 2, 3]
    assert {s.thread for s in by["fvy.upload"]} != {me}
    assert {s.thread for s in by["consume"] + by["fvy.prefetch.wait"]} == {me}
    for s in by["consume"]:
        up = next(u for u in by["fvy.upload"] if u.request == s.request)
        assert up.end_ns <= s.start_ns


def test_spans_share_the_profilers_clock(spans_on):
    """A span's in-memory start and end are those of its record_function
    range in a CPU torch.profiler trace, within 1 ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("fvy.warm"):  # the range op's first call resolves it
            pass
        with profiling.span("fvy.clock"):
            torch.ones(256, 256) @ torch.ones(256, 256)
    span = next(s for s in profiling.spans() if s.name == "fvy.clock")
    ev = next(e for e in prof.profiler.kineto_results.events() if e.name() == "fvy.clock")
    assert abs(ev.start_ns() - span.start_ns) < 1_000_000
    assert abs(ev.end_ns() - span.end_ns) < 1_000_000


def test_device_trace_turns_spans_on_and_a_bare_profiler_does_not(tmp_path):
    """Off, under a torch.profiler of the caller's: nothing records. Under
    `device_trace`: the span records, shows in the profiler's trace and in
    the Chrome trace it writes, and spans are off again after it."""
    import json

    from torch.profiler import ProfilerActivity, profile

    profiling.enable(False)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("fvy.bare"):
            torch.ones(8).sum()
    assert profiling.spans() == []
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.annotate("fvy.profiled"):
            torch.ones(8).sum()
    assert [s.name for s in profiling.spans()] == ["fvy.profiled"]
    assert "fvy.profiled" in [e.key for e in prof.key_averages()]
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())[
        "traceEvents"]}
    assert "fvy.profiled" in names and not profiling._on
    profiling.reset()


def test_program_cache_counts_builds_and_replays(spans_on):
    cache = ProgramCache("cpu")
    x = torch.ones(3)
    for _ in range(3):
        cache.run(("k", 3), lambda t: t + 1.0, x)
    cache.run(("j",), lambda t: t * 2.0, x)
    assert (cache.builds, cache.replays) == (2, 2)
    spans = profiling.spans()
    assert [(s.name, s.attrs) for s in sorted(spans, key=lambda s: s.start_ns)] == [
        ("fvy.program.build", {"key": ("k", 3)}),
        ("fvy.program.replay", {"key": "k"}),
        ("fvy.program.replay", {"key": "k"}),
        ("fvy.program.build", {"key": ("j",)})]
    profiling.enable(False)
    cache.run(("j",), lambda t: t * 2.0, x)
    assert (cache.builds, cache.replays) == (2, 3) and len(profiling.spans()) == 4


def _frames(n, h=48, w=80, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def test_fused_int8_detect_emits_its_spans_in_order(spans_on):
    conf = FdConf(weights_path="does_not_exist.weights")
    conf.nn_arch.image_size = S
    conf.hps.face_conf_th = 0.05
    fd = port_fd.FaceDetectorPipeline(conf, precision="int8", device="cpu")
    staged = _frames(4)
    geoms = [letterbox_geometry(48, 80, S)] * 4
    for _ in range(2):
        fd.detect_batch_fused(staged, geoms, pad_batch_to=4)
    spans = profiling.spans()
    assert _top(spans) == [
        "fvy.pipeline.init",
        "fvy.detect.inputs", "fvy.calibrate_int8", "fvy.program.build", "fvy.detect.fetch",
        "fvy.detect.inputs", "fvy.program.replay", "fvy.detect.fetch"]
    calib = next(s for s in spans if s.name == "fvy.calibrate_int8")
    tried = calib.attrs["tried"]
    assert calib.attrs["ladder"] == (0, 2, 4, 5, 6, 8)
    assert tried == calib.attrs["ladder"][:len(tried)] and calib.attrs["tail"] in tried
    assert calib.attrs["err"] == fd.int8_calib_err
    assert fd.programs.builds == 1 and fd.programs.replays == 1


def test_identify_chunk_emits_the_roi_plan_and_its_parts(spans_on):
    conf = Conf()
    conf.fi_conf.weights_path = conf.fd_conf.weights_path = "missing.weights"
    conf.fi_conf.nn_arch.image_size = conf.fd_conf.nn_arch.image_size = S
    conf.fi_conf.nn_arch.dense1_dim = 8
    conf.fi_conf.hps.sim_th = 10.0
    fi = port_fi.FaceIdentifierPipeline(conf, device="cpu")
    frames = list(_frames(2, 96, 128, seed=1))
    boxes = [np.array([[10, 12, 50, 60, 0.9], [60, 20, 100, 70, 0.8]]),
             np.array([[5, 5, 40, 45, 0.7]])]
    reg = fi.embed_device(np.random.default_rng(2).uniform(0, 1, (3, S, S, 3)))
    rows = fi._identify_chunk_device(frames, boxes, ["a", "b", "c"], reg)
    assert [len(r) for r in rows] == [2, 1]
    spans = profiling.spans()
    # Three ROIs: the programs of the pieces 2 and 1.
    assert _top(spans) == ["fvy.pipeline.init", "fvy.embed", "fvy.roi.plan", "fvy.roi.pack",
                           "fvy.program.build", "fvy.program.build", "fvy.identify.fetch"]
    plan = [s for s in spans if s.parent == "fvy.roi.plan"]
    assert sorted(s.name for s in plan) == ["fvy.roi.taps", "fvy.roi.windows"]
    assert [s.attrs["pipeline"] for s in spans if s.name == "fvy.pipeline.init"] == [
        "detector", "identifier"]


def test_spans_from_many_threads_lose_nothing(spans_on):
    """More threads than cores record nested spans while another copies the
    buffer out, under a short switch interval: every span is kept, and each
    names its own thread's parent."""
    import sys

    n_threads, n_spans = 16, 300
    done = threading.Event()

    def record(k):
        for _ in range(n_spans):
            with profiling.span(f"outer{k}"):
                with profiling.span(f"inner{k}"):
                    pass

    def copy_out():
        while not done.is_set():
            profiling.spans()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reader = threading.Thread(target=copy_out)
        reader.start()
        workers = [threading.Thread(target=record, args=(k,)) for k in range(n_threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        done.set()
        reader.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not reader.is_alive() and not any(t.is_alive() for t in workers)
    spans = profiling.spans()
    assert len(spans) == 2 * n_threads * n_spans
    for s in spans:
        k = s.name.removeprefix("outer").removeprefix("inner")
        assert s.parent == (None if s.name.startswith("outer") else f"outer{k}")
