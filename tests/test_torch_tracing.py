"""The port's recorder of spans and counters (``utils.profiling``): off it
reads no clock and opens no profiler range; on it records parents, roots
and self time on the profiler's clock; it turns on inside ``recording()``,
``trace()`` and any ``torch.profiler`` session, and only ``trace()`` puts
spans into the profiler's events; ``fit`` and ``fused_forward`` record the
step's and the request's spans; ``build_library`` counts its builds."""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from multimodn_tpu_torch import Adam, MultiModN
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.data import ArrayLoader, PartitionDataset
from multimodn_tpu_torch.ops import build
from multimodn_tpu_torch.utils import profiling
from multimodn_tpu_torch.utils.profiling import annotate, recording, span, \
    spans, trace

STEP_PHASES = ["step.forward", "step.backward", "step.optimizer"]


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.reset()
    yield
    profiling.reset()


def names(recorded):
    return [s.name for s in recorded]


def test_off_a_span_reads_no_clock_opens_no_range_and_records_nothing(
        monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("called while recording is off")

    monkeypatch.setattr(profiling, "perf_counter_ns", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for region in (span, annotate):
        with region("off", rows=3) as s:
            s.set(bytes=8)
    assert spans() == []


def test_outside_trace_a_span_stays_off_the_profilers_events():
    with recording(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("program-span"):
            torch.ones((8, 8)) @ torch.ones((8, 8))
    events = {e.name for e in prof.events()}
    assert "aten::mm" in events
    assert "program-span" not in events
    assert names(spans()) == ["program-span"]


def test_nested_spans_parents_roots_and_self_time(monkeypatch):
    clock = iter(range(0, 10_000, 10))
    monkeypatch.setattr(profiling, "perf_counter_ns", lambda: next(clock))
    with recording():
        with span("a") as a:            # a: 0 .. 70
            with span("b") as b:        # b: 10 .. 40
                with span("c") as c:    # c: 20 .. 30
                    pass
            with span("d", k=1) as d:   # d: 50 .. 60
                d.set(j=2)
        with span("e") as e:            # e: 80 .. 90
            pass
    rec = spans()
    assert names(rec) == ["c", "b", "d", "a", "e"]
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == \
        (None, a.id, b.id, a.id, None)
    assert {s.root for s in (a, b, c, d)} == {a.id} and e.root == e.id
    assert len({s.id for s in rec}) == 5
    assert d.attrs == {"k": 1, "j": 2}
    assert [s.duration_ns for s in (a, b, c, d, e)] == [70, 30, 10, 10, 10]
    assert [profiling.self_ns(s, rec) for s in (a, b, c, d, e)] == \
        [30, 20, 10, 10, 10]
    assert a.start_ns - profiling.clock_offset_ns() == 0


def test_recording_follows_a_profiler_session():
    with span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with span("during"):
            pass
    with span("after"):
        pass
    assert names(spans()) == ["during"]


def test_span_times_lie_on_the_profilers_clock():
    """Each span wraps a range of the profiler's own; their starts and
    ends agree to 50 µs on ``trace_start_ns()`` plus ``time_range``."""
    wrapped = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(10):
            with span("outer") as s:
                with record_function(f"probe-{i}"):
                    torch.ones((64, 64)) @ torch.ones((64, 64))
            wrapped.append(s)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    probes = {e.name: e.time_range for e in prof.events()
              if e.name.startswith("probe-")}
    gaps = []
    for i, s in enumerate(wrapped):
        r = probes[f"probe-{i}"]
        begin, end = start_ns + r.start * 1e3, start_ns + r.end * 1e3
        assert s.start_ns <= begin + 50e3 and s.end_ns >= end - 50e3
        gaps.append((begin - s.start_ns, s.end_ns - end))
    assert min(g for g, _e in gaps) < 50e3
    assert min(e for _g, e in gaps) < 50e3


def test_trace_writes_the_programs_spans(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        with span("traced-span"):
            torch.ones((16, 16)) @ torch.ones((16, 16))
    with open(os.path.join(logdir, "trace.json")) as f:
        events = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "traced-span" in events
    assert names(spans()) == ["traced-span"]
    with span("after-trace"):
        pass
    assert names(spans()) == ["traced-span"]


def tiny_model(device="cpu"):
    return MultiModN(4, [tenc.MIMICMLPEncoder(4, w, (5,)) for w in (2, 3)],
                     [tdec.MLPDecoder(4, (5,), 2)], 1.0, 0.0, seed=0,
                     device=device)


def tiny_data(n=40):
    X = np.random.default_rng(0).normal(size=(n, 5)).astype(np.float32)
    X[::7, 3] = np.nan
    y = (X[:, 0] > 0).astype(np.int64)
    return X, PartitionDataset(X, y, [2, 3])


def test_fit_records_the_loader_and_the_steps_phases():
    _X, ds = tiny_data()
    loader = ArrayLoader(ds, 16, shuffle=True)
    epochs = 2
    with recording():
        tiny_model().fit(loader, Adam(0.01), "cross_entropy", epochs=epochs)
    rec = spans()
    by_id = {s.id: s for s in rec}
    roots = [s for s in rec if s.parent is None]
    assert names(roots) == epochs * (["loader.stacks"]
                                     + loader.n_batches * ["train.step"])
    data, targets, mask = loader.host_stacks()
    sent = sum(a.nbytes for a in (*data, targets, mask))
    assert sent == 3 * 16 * (5 * 4 + 8 + 4)
    for root in roots:
        children = [s for s in rec if s.parent == root.id]
        if root.name == "loader.stacks":
            assert names(children) == ["loader.order", "loader.to_device"]
            assert children[1].attrs == {"bytes": sent}
        else:
            assert names(children) == STEP_PHASES
            assert profiling.self_ns(root, rec) >= 0
    steps = [s for s in roots if s.name == "train.step"]
    assert [s.attrs["rows"] for s in steps] == epochs * [16, 16, 8]
    assert all(by_id[s.root].parent is None for s in rec)


@pytest.mark.parametrize("host", [True, False])
def test_fused_forward_records_the_requests_stages(host):
    X, _ds = tiny_data()
    x = [X[:, :2], X[:, 2:]]
    if not host:
        x = [torch.as_tensor(m) for m in x]
    model = tiny_model()
    with recording():
        model.fused_forward(x)
    rec = spans()
    assert names(rec) == ["request.pack", "request.mask", "request"]
    request = rec[-1]
    assert request.attrs == {"rows": 40}
    # The packed rows as the kernel reads them, each modality padded.
    assert rec[0].attrs == {"bytes": 40 * model._chain_spec.data_ld * 4}
    assert all(s.parent == s.root == request.id for s in rec[:2])


def test_counters_read_the_launches_and_count_builds(monkeypatch, tmp_path):
    from multimodn_tpu_torch.ops.fused_adam import FUSED_ADAM
    from multimodn_tpu_torch.ops.fused_chain import FUSED_CHAIN
    first = profiling.counters()
    assert first["k1.launches"] == FUSED_CHAIN.launches
    assert first["k2.launches"] == FUSED_ADAM.launches

    def nvcc(cmd, **_kw):
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("built")
        return type("Done", (), {"returncode": 0, "stdout": "",
                                 "stderr": ""})()

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", nvcc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    for _ in range(2):
        build.build_library("fused_chain.cu")
    assert profiling.counters()["kernels.built"] == first["kernels.built"] + 1


@pytest.mark.cuda
def test_program_spans_add_no_device_event_under_a_profiler(monkeypatch):
    """Under a plain profiler session with CUDA activity, a
    ``fused_forward`` that records its spans gives the benchmark's trace
    view the same device events as one that cannot record."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "tests/test_torch_cuda.py")
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark.harness.trace import WINDOW, View

    from multimodn_tpu_torch.ops.fused_chain import FUSED_CHAIN

    X, _ds = tiny_data(4096)
    model = tiny_model(device="cuda")
    x = [torch.as_tensor(X[:, :2], device="cuda"),
         torch.as_tensor(X[:, 2:], device="cuda")]
    model.fused_forward(x)
    torch.cuda.synchronize()

    def session():
        """The device events of one request under a profiler session, or
        None where CUPTI delivered none."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                model.fused_forward(x)
                torch.cuda.synchronize()
        events = prof.events()
        if not any(e.device_type == torch.autograd.DeviceType.CUDA
                   for e in events):
            return None
        return View(events, set(), 1.0).device

    def device_events():
        """The most device events of three sessions: CUPTI now and then
        loses an event of a session."""
        return max((session() or [] for _ in range(3)), key=len)

    # CUPTI may deliver nothing for a process's first sessions: warm it
    # up until it delivers, outside the comparison.
    for _ in range(50):
        if session():
            break
    profiling.reset()
    launches = FUSED_CHAIN.launches
    recorded = device_events()
    assert names(spans()) == 3 * ["request.pack", "request.mask",
                                  "k1.enqueue", "request"]
    per_call = (FUSED_CHAIN.launches - launches) // 3
    assert per_call > 0
    assert [s.attrs for s in spans() if s.name == "k1.enqueue"] == \
        3 * [{"launches": per_call}]
    profiling.reset()
    off = type("Off", (), {"_is_profiler_enabled": False})()
    monkeypatch.setattr(profiling, "_autograd_profiler", off)
    unrecorded = device_events()
    assert spans() == []
    assert len(recorded) == len(unrecorded)
    assert not {n for n, _s, _e in recorded} & {
        "request", "request.pack", "request.mask", "k1.enqueue"}
