"""Each cell's control comes out as not correct: the plain reference at the
precision below the cell's (int4 for int8, scaled fp8 for bf16, TF32 for
f32 with TF32 off) put in the program's place, at the cell's own size, on
three seeds, fails one of the cell's numbers. Runs on the card; the limits
of cells/<cell>.json were set from these readings and the program's
(PERF.md §2).

    python -m pytest fvy_bench/tests/test_fvy_bench_control.py -m card
"""

import json
from pathlib import Path

import pytest
import torch

from fvy_bench.harness.readings import control_numbers

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEEDS = (4100000001, 4100000002, 4100000003)


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_the_check(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    limits = json.loads((ROOT / "fvy_bench" / "cells" / f"{workload}.json").read_text())[
        "limits"]
    for seed in SEEDS:
        numbers = control_numbers(workload, seed)
        assert any(numbers[k] > limits[k] for k in limits), (seed, numbers)
