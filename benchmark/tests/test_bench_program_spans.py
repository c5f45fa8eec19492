"""The readers of the program's spans (``harness/program_spans.py`` and the
metrics that use it) on a synthetic record of a ``--trace 1`` run: an
earlier run's spans, then the traced slice, then the hosted slice, each
slice the same work with other durations. Each reader must read the traced
slice alone, and give None where the program recorded too little or has
no recorder."""
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness.cells import Cell  # noqa: E402
from multimodn_tpu_torch.utils import profiling  # noqa: E402

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
MS = 1_000_000
STEPS, EPOCH_STEPS, REQUESTS = 4, 2, 3


class Recorder:
    """Spans in the recorder's layout, appended as each ends."""

    def __init__(self):
        self.spans, self.t, self.ids = [], 0, 0

    def add(self, name, ms, children=(), **attrs):
        """A root span of ``children`` (``(name, ms, attrs)``, one after
        another, then ``ms`` more of its own)."""
        self.ids += 1
        root = self.ids
        start = self.t
        for child, cms, cattrs in children:
            self.ids += 1
            self.spans.append(_span(self.ids, root, root, child, self.t,
                                    self.t + cms * MS, cattrs))
            self.t += cms * MS
        self.t += ms * MS
        self.spans.append(_span(root, None, root, name, start, self.t,
                                attrs))
        self.t += MS


def _span(id_, parent, root, name, start, end, attrs):
    s = profiling.Span(name, dict(attrs))
    s.id, s.parent, s.root, s.start_ns, s.end_ns = id_, parent, root, \
        start, end
    return s


def training(rec, k, epochs):
    """``epochs`` epochs of ``EPOCH_STEPS`` steps, every time times
    ``k``."""
    for _ in range(epochs):
        rec.add("loader.stacks", 0.5 * k, [
            ("loader.order", 1.0 * k, {}),
            ("loader.to_device", 0.5 * k, {"bytes": 8_000_000 * k})])
        for _ in range(EPOCH_STEPS):
            rec.add("train.step", 0.25 * k, [
                ("step.forward", 3.0 * k, {}),
                ("step.backward", 4.0 * k, {}),
                ("step.optimizer", 1.0 * k, {})], rows=64)


def scoring(rec, k, requests):
    for _ in range(requests):
        rec.add("request", 0.1 * k, [
            ("request.pack", 0.2 * k, {"bytes": 1000}),
            ("request.mask", 0.3 * k, {}),
            ("k1.enqueue", 0.4 * k, {"launches": 2})], rows=34537)


def run_record():
    """An earlier run's slices (times x 100), then a run's traced (x 1)
    and hosted (x 10) slices."""
    rec = Recorder()
    training(rec, 100, 1)
    scoring(rec, 100, 2)
    for k in (1, 10):
        training(rec, k, STEPS // EPOCH_STEPS)
        scoring(rec, k, REQUESTS)
    return rec.spans


def reading(counts):
    return type("Reading", (), {"view": None, "spans": [], "peak": {},
                                "counts": counts})()


def program_metrics(cell):
    return [m["name"] for m in Cell(cell, BENCH).per_layer
            if m["source"] == "program_span"
            and m["name"] != "host_ms_per_request.score"]


EXPECTED = {
    "loader_host_ms_per_step.train": 2.0 * 2 / STEPS,
    "h2d_mb_per_step.train": 8.0 * 2 / STEPS,
    "forward_host_ms_per_step.train": 3.0,
    "backward_host_ms_per_step.train": 4.0,
    "optimizer_host_ms_per_step.train": 1.0,
    "pack_host_ms_per_request.score": 0.2,
    "mask_host_ms_per_request.score": 0.3,
    "k1_host_ms_per_request.score": 0.4,
}
COUNTS = {"cxr-resnet18-train-b64": {"steps": STEPS},
          "haim-score-b34537": {"requests": REQUESTS}}
CASES = [(cell, name) for cell in COUNTS for name in program_metrics(cell)]


def test_every_program_span_metric_is_tested():
    assert sorted(name for _c, name in CASES) == sorted(EXPECTED)


@pytest.mark.parametrize("cell,name", CASES)
def test_a_reader_reads_the_traced_slice_alone(monkeypatch, cell, name):
    record = run_record()
    monkeypatch.setattr(profiling, "spans", lambda: list(record))
    value = Cell(cell, BENCH).reader(name).read(reading(COUNTS[cell]))
    assert value == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("cell,name", CASES)
def test_a_reader_gives_none_where_too_little_was_recorded(monkeypatch, cell,
                                                           name):
    reader = Cell(cell, BENCH).reader(name)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader.read(reading(COUNTS[cell])) is None
    one_slice = Recorder()
    training(one_slice, 1, STEPS // EPOCH_STEPS)
    scoring(one_slice, 1, REQUESTS)
    monkeypatch.setattr(profiling, "spans", lambda: one_slice.spans)
    assert reader.read(reading(COUNTS[cell])) is None
    record = run_record()
    monkeypatch.setattr(profiling, "spans", lambda: record)
    assert reader.read(reading({})) is None


@pytest.mark.parametrize("cell,name", CASES)
def test_a_reader_gives_none_for_a_program_with_no_recorder(monkeypatch,
                                                            cell, name):
    monkeypatch.delattr(profiling, "spans")
    assert Cell(cell, BENCH).reader(name).read(
        reading(COUNTS[cell])) is None
