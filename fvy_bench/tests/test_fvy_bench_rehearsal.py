"""Every cell of BENCHMARK.json end to end on the CPU at a tiny size,
through the harness (`run.execute`, which skips the look for a card) with
the kernels' plain versions, and the look for a card itself."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from fvy_bench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY_STREAM = {"config": {"image_size": 64},
               "traffic": {"height": 48, "width": 80, "chunk": 4, "ring_chunks": 2,
                           "face_radius": [4, 8]},
               "cell": {"warmup_chunks": 1, "check_chunks": 1}}
TINY_TRAIN = {"config": {"image_size": 64},
              "traffic": {"height": 64, "width": 64, "chunk": 4, "ring_chunks": 4,
                          "face_radius": [4, 8]}}
TINY_IDENTIFY = {"config": {"image_size": 64},
                 "traffic": dict(TINY_STREAM["traffic"], registry={
                     "subjects": 12, "height": 64, "width": 64, "faces_per_frame": [1, 1],
                     "face_radius": [10, 20]}),
                 "cell": TINY_STREAM["cell"]}


@pytest.fixture
def tiny(monkeypatch):
    """The overrides that make a cell tiny; the identify cell's front
    detector shrinks with it."""
    from fvy_bench.drivers import identify

    front = identify.front_detector
    monkeypatch.setattr(identify, "front_detector",
                        lambda ctx: dict(front(ctx), image_size=64))

    def of(workload: str) -> dict:
        driver = json.loads(
            (ROOT / "fvy_bench" / "cells" / f"{workload}.json").read_text())["driver"]
        return {"train": TINY_TRAIN, "identify": TINY_IDENTIFY}.get(driver, TINY_STREAM)

    return of


def metric_names(table: str, workload: str) -> set[str]:
    return {m["name"] for m in BENCH[table] if run.applies(m, workload)}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_on_the_cpu(tiny, workload, trace):
    res = run.execute(workload, 2**31 + 12345, 0.5, bool(trace), "cpu", tiny(workload))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    if trace:
        # A CPU trace has no device: the readers of device time report
        # what they find; the others are all there.
        assert set(res["metrics"]) <= metric_names("per_layer", workload)
        assert "window_s" in res["device"] and "breakdown" in res
    else:
        assert set(res["metrics"]) == metric_names("end_to_end", workload)
        assert "setup_s" in res["metrics"]


def test_without_a_card_it_prints_no_result():
    out = subprocess.run([sys.executable, "fvy_bench/run.py", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
