"""Run one cell of the benchmark of face_vijnana_yolov3_tpu_torch once.

    python3 fvy_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Everything is found by the names in BENCHMARK.json: the cell's
configuration (configs/<config>.json), its traffic (traffic/<traffic>.json),
the cell's own settings and limits (cells/<cell>.json, which names the
driver, drivers/<driver>.py) and each per-layer metric's reader
(metrics/<metric>.py). With --trace 0 the last line of standard output is
the cell's end-to-end metrics, with --trace 1 its per-layer metrics, read
from a torch.profiler trace of the window, with the trace's `breakdown`.
The numbers the run compared with the plain reference are its last lines
on standard error, and the result line's last key.

The run binds itself to the CPUs of the card's NUMA node and fixes its
CPU thread count (THREADS) before it allocates pinned memory: the host
path paces the int8 stream, and both steady it.
"""

from __future__ import annotations

import os
import sys
import time

T_START = time.perf_counter()
THREADS = 4
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(THREADS)

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# Kernel caches at fixed paths inside the checkout (the port builds its
# CUDA kernels into build/torch_kernels itself).
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton_cache"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

# Top-level module names that may not be loaded: JAX and the JAX package
# (compared whole: the port's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "face_vijnana_yolov3_tpu")


def numa_cpus(device_index: int) -> set[int] | None:
    """The CPUs of the card's NUMA node that this process may use, or None
    where the machine does not say (one node, or no node for the card)."""
    props = torch.cuda.get_device_properties(device_index)
    try:
        pci = (f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:"
               f"{props.pci_device_id:02x}.0")
        node = int(Path(f"/sys/bus/pci/devices/{pci}/numa_node").read_text())
        if node < 0:
            return None
        text = Path(f"/sys/devices/system/node/node{node}/cpulist").read_text().strip()
    except (AttributeError, OSError, ValueError):
        return None
    cpus: set[int] = set()
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus & os.sched_getaffinity(0) or None


def bind_to_card(device_index: int) -> list[int] | None:
    """Every thread of this process onto the card's NUMA node's CPUs."""
    cpus = numa_cpus(device_index)
    if cpus is None:
        return None
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:
            pass
    return sorted(cpus)


def forbidden_modules() -> list[str]:
    """The FORBIDDEN top-level names that this process has loaded."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(workload: str) -> tuple[dict, dict, dict, dict, dict]:
    """(BENCHMARK.json, its entry of the workload, the workload's
    configuration, traffic and cell settings)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"run.py: no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return (bench, entry, load_json(ROOT / config["file"]),
            load_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
            load_json(BENCH / "cells" / f"{workload}.json"))


def make_context(workload: str, seed: int, seconds: float, trace: bool, device,
                 config: dict, traffic: dict, cell: dict):
    from fvy_bench.harness.trace import Spans

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    return SimpleNamespace(
        root=ROOT, workload=workload, seed=seed, seconds=seconds, trace=trace,
        device=dev, config=config, traffic=traffic, cell=cell, t_start=T_START,
        spans=Spans(trace),
        sync=(torch.cuda.synchronize if cuda else (lambda: None)),
        memory_peak=((lambda: torch.cuda.max_memory_allocated(dev)) if cuda else (lambda: 0)),
        free=(torch.cuda.empty_cache if cuda else (lambda: None)))


def driver(cell: dict):
    return importlib.import_module(f"fvy_bench.drivers.{cell['driver']}")


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"fvy_bench_metric_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            overrides: dict | None = None) -> dict:
    """One run of a cell on `device`, without the look for a card: the
    result line's dict. `overrides` ({"config": {...}, "traffic": {...},
    "cell": {...}}) merges into those files' settings (the CPU rehearsals'
    tiny sizes)."""
    bench, _, config, traffic, cell = cell_files(workload)
    for name, part in (("config", config), ("traffic", traffic), ("cell", cell)):
        part.update((overrides or {}).get(name, {}))
    ctx = make_context(workload, seed, seconds, trace, device, config, traffic, cell)
    out = driver(cell).run(ctx)
    if trace:
        run_rec = {"trace": out["trace"], "record": out["record"], "config": config}
        metrics = {}
        for m in bench["per_layer"]:
            if applies(m, workload):
                v = metric_reader(m["name"])(run_rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if applies(m, workload)}
    dev = torch.device(device)
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                                  else "cpu"),
                         "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]},
              "info": out.get("info", {})}
    if trace:
        from fvy_bench.harness.trace import breakdown

        result["device"].update(busy_s=out["trace"]["busy_s"],
                                window_s=out["trace"]["window_s"])
        result["breakdown"] = breakdown(out["trace"])
    result["checks"] = out["checks"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _, entry, _, _, _ = cell_files(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"run.py: the cell needs {entry['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    bound = bind_to_card(0)
    print(f"run.py: {THREADS} CPU threads, CPUs {bound if bound else 'unbound'}",
          file=sys.stderr)
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    loaded = forbidden_modules()
    if loaded:
        print(f"run.py: the process loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
