"""The readings a cell's limits are set from, on the card: the compared
numbers of sound runs of the program over many seeds (short windows at the
cell's own load, all in one process), and of the control, the reference at
the precision below the cell's put in the program's place.

    python3 -m fvy_bench.harness.readings --workload <cell> --seeds 1,2,3 \
        [--seconds 3] [--control | --fault half_batch]

prints one JSON line per seed: the program's compared numbers with their
limits and `correct`, or those of the control or of a planted fault (the
reference put in the program's place).
"""

from __future__ import annotations

import argparse
import json

# The precision below each cell precision (the control).
CONTROLS = {"int8": {"qmax": 7}, "bfloat16": {"fp8": True}, "float32": {"tf32": True}}
# Faults a training cell is held against besides the control.
FAULTS = {"half_batch": {"half_batch": True}}


def control_numbers(workload: str, seed: int, device="cuda", overrides=None,
                    fault: str | None = None) -> dict:
    from fvy_bench import run

    _, _, config, traffic, cell = run.cell_files(workload)
    for name, part in (("config", config), ("traffic", traffic), ("cell", cell)):
        part.update((overrides or {}).get(name, {}))
    ctx = run.make_context(workload, seed, 0.0, False, device, config, traffic, cell)
    return run.driver(cell).readings(ctx, FAULTS[fault] if fault else CONTROLS[cell["precision"]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    from fvy_bench import run

    for seed in (int(s) for s in args.seeds.split(",")):
        if args.control or args.fault:
            out = {"seed": seed, args.fault or "control":
                   control_numbers(args.workload, seed, fault=args.fault)}
        else:
            res = run.execute(args.workload, seed, args.seconds, False, "cuda")
            out = {"seed": seed, "correct": res["correct"], "checks": res["checks"],
                   "info": res["info"]}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
