"""``BENCHMARK.json`` against the files that the harness finds by its
names, the contract's limits on names and bounds, and the per-layer
readers on a synthetic trace."""
import json
import os
import re
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import trace  # noqa: E402
from benchmark.harness.cells import Cell, load_json  # noqa: E402

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_the_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_bounds():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_config_file_and_its_counts_exist():
    for c in BENCH["configs"]:
        cfg = load_json("configs", c["name"] + ".json")
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(HERE, "counts",
                                           c["name"] + ".py"))


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = Cell(name, BENCH)
    assert hasattr(cell.driver, "setup") and hasattr(cell.driver, "check")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert hasattr(cell.reader(m["name"]), "read")
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


def test_per_layer_metrics_name_their_layer_and_moved_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["layer"] and "\n" not in m["layer"]
        assert set(m["workloads"]) <= set(CELLS)


class Event:
    def __init__(self, name, start_us, end_us, cuda):
        import torch
        self.name = name
        self.time_range = type("R", (), {"start": start_us,
                                         "end": end_us})()
        self.device_type = torch.autograd.DeviceType.CUDA if cuda else \
            torch.autograd.DeviceType.CPU


def view():
    events = [Event(trace.WINDOW, 0, 1000, False),
              Event("aten::index", 100, 400, False),
              Event("cudaMemcpyAsync", 350, 400, False),
              Event("aten::copy_", 740, 790, False),
              Event("cudaMemcpyAsync", 760, 790, False),
              Event("score.fused_forward", 400, 900, False),
              Event("stage_a_gemm(StageAArgs)", 420, 520, True),
              Event("void chain_kernel<LargeTiles, 64>(ChainArgs)", 520, 700,
                    True),
              Event("Memcpy DtoH (Device -> Pageable)", 700, 750, True),
              Event("score.fused_forward", 400, 900, True),
              Event("elementwise_kernel", 800, 850, True)]
    return trace.View(events, {"score.fused_forward"})


def test_the_trace_view_reads_busy_time_and_gaps():
    v = view()
    assert v.window_s == pytest.approx(1e-3)
    assert v.busy_s == pytest.approx(380e-6)
    assert v.idle_share() == pytest.approx(0.62)
    assert len(v.kernels) == 3
    gaps = dict(v.idle_gaps())
    assert gaps["host: aten::index"] == pytest.approx(420e-6)
    assert gaps["host: aten::copy_ / cudaMemcpyAsync"] == \
        pytest.approx(50e-6)
    assert gaps["host: none"] == pytest.approx(150e-6)
    assert sum(gaps.values()) == pytest.approx(620e-6)
    assert v.top_ops()[0][0].startswith("void chain_kernel")


def test_the_readers_on_a_synthetic_trace():
    v = view()
    peak = load_json("peaks.json")["NVIDIA H100"]
    spans = [("score.fused_forward", 0.0, 0.0005, False),
             ("score.fused_forward", 1.0, 1.0015, True)]
    r = type("Reading", (), {"view": v, "spans": spans, "peak": peak,
                             "counts": {"requests": 1,
                                        "useful_flops": 6.7e9,
                                        "k1_bound_s": 140e-6,
                                        "peak_flops": "fp32_flops"}})()
    cell = Cell("haim-score-b34537", BENCH)
    read = {m["name"]: cell.reader(m["name"]).read(r)
            for m in cell.per_layer}
    assert read["host_ms_per_request.score"] == pytest.approx(0.5)
    assert read["k1_roofline"] == pytest.approx(50.0)
    assert read["mfu.score"] == pytest.approx(10.0)
    assert read["device_idle_pct.score"] == pytest.approx(62.0)
    train = Cell("cxr-resnet18-train-b64", BENCH)
    for m in train.per_layer:
        assert train.reader(m["name"]).read(r) is None


def tiny_score_cell():
    cell = Cell("haim-score-b34537", BENCH)
    cell.traffic = dict(cell.traffic, rows=256, chunks=2, warmup_requests=2,
                        checked_within=4, checked_requests=2)
    return cell


def test_set_up_calls_leave_no_span_in_the_slices(monkeypatch):
    from benchmark.run import run_cell
    cell = tiny_score_cell()
    seen = []
    real = cell.driver.window

    def window(state, run, **work):
        seen.append(len(run.spans))
        return real(state, run, **work)

    monkeypatch.setattr(cell.driver, "window", window)
    result, _checks = run_cell(cell, 2 ** 31 + 7, 0.1, False, "cpu")
    assert seen == [0]
    assert result["correct"]
