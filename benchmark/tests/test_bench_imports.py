"""No module of the benchmark imports JAX, its libraries or the JAX
package, and the reference imports nothing of the program; names are
compared whole by their top-level part."""
import ast
import contextlib
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402
from benchmark.harness import trace  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "optax", "orbax", "multimodn_tpu", "multimodn",
             "pipelines", "nips", "native"}
PROGRAM = "multimodn_tpu_torch"


def modules():
    for folder, _dirs, files in os.walk(HERE):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(folder, name)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_benchmark_has_modules():
    paths = list(modules())
    assert len(paths) > 20
    assert os.path.join(HERE, "run.py") in paths


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_module_imports_jax_or_the_jax_package(path):
    found = top_level_imports(path) & FORBIDDEN
    assert not found, f"{path} imports {sorted(found)}"


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for folder, _dirs, files in os.walk(ref):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(folder, name)
                assert PROGRAM not in top_level_imports(path), path
                with open(path) as f:
                    assert "benchmark.modules" not in f.read(), path


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FOREIGN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "multimodn_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxonomy", object())
    assert run.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "multimodn_tpu.model", object())
    assert run.foreign_modules() == ["jax", "multimodn_tpu"]


class StubView:
    busy_s, window_s = 0.5, 1.0

    def top_ops(self):
        return []

    def idle_gaps(self):
        return []


@contextlib.contextmanager
def stub_profiled(r, host):
    holder = type("Traced", (), {})()
    yield holder
    holder.view = StubView()


@pytest.mark.parametrize("stage", ["check", "reader"])
def test_a_foreign_module_loaded_after_the_window_ends_the_run(
        monkeypatch, capsys, stage):
    """The guard looks again once the readers and the check have run: a
    foreign module that either loads leaves no result."""
    from benchmark.harness.cells import Cell
    for name in list(sys.modules):
        if name.split(".")[0] in run.FOREIGN:
            monkeypatch.delitem(sys.modules, name)
    cell = Cell("haim-score-b34537")
    cell.traffic = dict(cell.traffic, rows=256, chunks=2, warmup_requests=2,
                        checked_within=4, checked_requests=2)
    real = cell.driver.check

    def check(state, r):
        if stage == "check":
            monkeypatch.setitem(sys.modules, "jax", object())
        return real(state, r)

    def reader(metric):
        monkeypatch.setitem(sys.modules, "flax.linen", object())
        return type("Reader", (), {"read": staticmethod(lambda r: None)})

    monkeypatch.setattr(cell.driver, "check", check)
    if stage == "reader":
        # Readers are loaded in a traced run; the CPU gives the profiler
        # no device to trace, so the slice's view is a stub.
        monkeypatch.setattr(cell, "reader", reader)
        monkeypatch.setattr(trace, "profiled", stub_profiled)
        monkeypatch.setattr(cell, "peak",
                            lambda kind: cell.peaks["NVIDIA H100"])
    with pytest.raises(SystemExit) as ended:
        run.run_cell(cell, 2 ** 31 + 9, 0.1, stage == "reader", "cpu")
    assert ended.value.code == 1
    err = capsys.readouterr().err
    assert ("jax" if stage == "check" else "flax") in err
