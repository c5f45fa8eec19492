"""The readings that the limits of ``workloads/<cell>.json`` are set from:
the numbers a cell's check compares, for many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--side program|tf32|fault:<name>] [--seconds 1]

``program`` is the run as the benchmark makes it (the lower readings);
``tf32`` is the control, one precision below the configuration's fp32 (the
training driver runs the program with TF32 on, the scoring driver puts the
reference in TF32 in the program's place); ``fault:<name>`` plants a fault
of ``faults.py``. Each seed runs the cell as ``run.py`` does, with a window
of ``--seconds`` (at the cell's own load), and prints one JSON line of its
readings; the last line gives the largest and the smallest of each. The
benchmark's own runs never run this.
"""
import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--side", default="program")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    import torch

    from benchmark import faults
    from benchmark.harness.cells import Cell
    from benchmark.run import run_cell

    cell = Cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 3
    side = "program" if args.side.startswith("fault:") else args.side
    plant = contextlib.nullcontext()
    if args.side.startswith("fault:"):
        plant = faults.planted(cell.traffic["driver"],
                               args.side.split(":", 1)[1])
    readings = {}
    with plant:
        for seed in args.seeds:
            result, checks = run_cell(cell, seed, args.seconds, False,
                                      "cuda", side=side)
            line = {"seed": seed, "side": args.side,
                    "correct": result["correct"]}
            line.update({name: value for name, value, _l in checks})
            print(json.dumps(line), flush=True)
            for name, value, _l in checks:
                readings.setdefault(name, []).append(value)
    print(json.dumps({"workload": args.workload, "side": args.side,
                      "seeds": len(args.seeds),
                      "largest": {k: max(v) for k, v in readings.items()},
                      "smallest": {k: min(v) for k, v in readings.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
