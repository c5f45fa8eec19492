"""A cell's files, found by the names in ``BENCHMARK.json``: the
configuration (``configs/<config>.json``), the traffic mix
(``traffic/<traffic>.json``, which names its driver), the driver
(``drivers/<driver>.py``), the cell's limits (``workloads/<cell>.json``),
the configuration's counts (``counts/<config>.py``) and each per-layer
metric's reader (``metrics/<metric>.py``)."""
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(*parts):
    """A Python file of the benchmark by its path (names may hold '-' and
    '.', so they are not imported by name)."""
    path = os.path.join(HERE, *parts)
    name = "benchmark_" + "_".join(parts).replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """Everything one run of a cell reads, by name."""

    def __init__(self, name: str, bench: dict = None):
        if bench is None:
            with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
                bench = json.load(f)
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[name]
        self.chips = self.entry["chips"]
        self.config = load_json("configs", self.entry["config"] + ".json")
        self.traffic = load_json("traffic", self.entry["traffic"] + ".json")
        self.limits = load_json("workloads", name + ".json")["limits"]
        self.driver = load_module("drivers", self.traffic["driver"] + ".py")
        self.counts = load_module("counts", self.entry["config"] + ".py")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.peaks = load_json("peaks.json")

    def peak(self, kind: str) -> dict:
        for key, value in self.peaks.items():
            if key != "source" and kind.startswith(key):
                return value
        raise KeyError(f"no peaks for {kind!r} in peaks.json")

    def reader(self, metric: str):
        return load_module("metrics", metric + ".py")
