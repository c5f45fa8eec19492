"""``multimodn_tpu_torch.utils.profiling``: the JAX package's profiling
tests (``test_profiling.py``) on the port, and the trace holding the
annotated regions."""
import json
import os

import torch

from multimodn_tpu_torch.utils.profiling import EpochTimer, annotate, sync, \
    trace


def test_epoch_timer_counts_and_syncs():
    logs = []
    x = torch.ones((8, 8))
    timer = EpochTimer(logger=logs.append, log_every=2, sync_tree={"x": [x]})
    for _ in range(4):
        with timer.epoch():
            x = x * 1.0
    assert len(timer.times) == 4
    assert timer.last_s >= 0 and timer.mean_s >= 0
    assert len(logs) == 2  # every 2 epochs
    assert EpochTimer().last_s == EpochTimer().mean_s == 0.0


def test_trace_writes_profile(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        with annotate("tiny-matmul"):
            y = torch.ones((16, 16)) @ torch.ones((16, 16))
            sync(y)
    found = []
    for _root, _dirs, files in os.walk(logdir):
        found += files
    assert found, "profiler trace produced no files"
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "tiny-matmul" in names
    assert any(str(n).startswith("aten::mm") for n in names)
