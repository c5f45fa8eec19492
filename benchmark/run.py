"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's files are found by the names in
``BENCHMARK.json``. The run makes its weights and inputs on the card from
the seed, warms up the cell's shapes (set-up, timed from the start of the
process), measures for ``--seconds`` (``--trace 0``: the end-to-end
metrics) or traces a fixed slice of the same traffic (``--trace 1``: the
per-layer metrics, after an untraced slice of the same work), and then,
with the program's state freed, checks the timed path's results against
the plain reference of ``reference/``. Each compared number is printed
beside its limit as the last lines on standard error; the last line on
standard output is the result as one JSON object.

Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits with 3.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Top-level module names that no run may hold: JAX and its libraries, and
# the JAX package with the repository's other JAX-era top-level packages.
FOREIGN = ("jax", "jaxlib", "flax", "optax", "orbax", "multimodn_tpu",
           "multimodn", "pipelines", "nips", "native")
THREADS = 2


def foreign_modules() -> list:
    """The foreign top-level names in ``sys.modules``, compared whole (so
    ``multimodn_tpu_torch`` is not ``multimodn_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FOREIGN))


def refuse_foreign(stage: str):
    """End the run with no result where ``stage`` loaded a foreign
    module, naming what it found on standard error."""
    found = foreign_modules()
    if found:
        print(f"run.py: foreign modules loaded by {stage}: {found}",
              file=sys.stderr)
        raise SystemExit(1)


class Reading:
    """What a per-layer reader (``metrics/<name>.py``) reads."""

    def __init__(self, view, counts, spans, peak):
        self.view, self.counts, self.spans, self.peak = \
            view, counts, spans, peak


def card_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             start: float = None, side: str = "program") -> tuple:
    """One run of ``cell``; returns ``(result, checks)`` with ``checks`` a
    list of ``(name, value, limit)``. ``device`` may be the CPU in tests,
    which skip the look for a card."""
    import torch

    from benchmark.harness import trace as tracing
    from benchmark.harness.runner import Run, exact_math

    start = time.perf_counter() if start is None else start
    exact_math()
    torch.set_num_threads(THREADS)
    run = Run(cell, seed, device, side)
    cuda = run.device.type == "cuda"
    run.kind = torch.cuda.get_device_name(run.device) if cuda else "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    driver = cell.driver
    state = driver.setup(run)
    refuse_foreign("set-up")
    run.sync()
    setup_s = time.perf_counter() - start
    run.spans.clear()       # set-up's warm-up calls are no part of a slice
    view = None
    if trace:
        work = driver.traced_slice(cell.traffic)
        driver.window(state, run, **work)       # untraced: the spans
        with tracing.profiled(run, host=False) as traced:
            stats = driver.window(state, run, **work)
        with tracing.profiled(run, host=True) as hosted:
            driver.window(state, run, **work)   # host ops: the idle gaps
        view = traced.view
    else:
        stats = driver.window(state, run, seconds=seconds)
    peak_bytes = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    refuse_foreign("the window")
    values, attempted, failed = driver.results(state, stats)
    metrics = {}
    if trace:
        reading = Reading(view, driver.counts(run, state, stats), run.spans,
                          cell.peak(run.kind) if cuda else {})
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(values, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    driver.release(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = [(name, value, cell.limits[name])
              for name, value in driver.check(state, run)]
    correct = failed == 0 and all(value <= limit
                                  for _n, value, limit in checks)
    dev = {"platform": "gpu" if cuda else "cpu", "kind": run.kind,
           "count": cell.chips, "memory_peak_bytes": peak_bytes,
           "card": card_limit() if cuda else "none"}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
        result["breakdown"] = {"device_ops": view.top_ops(),
                               "idle_gaps": hosted.view.idle_gaps()}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    refuse_foreign("the readers and the check")
    return result, checks


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from benchmark.harness.cells import Cell

    cell = Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", start=START)
    sys.stdout.flush()
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
