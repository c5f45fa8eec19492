"""The reference's import paths on top of the port.

A reference pipeline body imports ``multimodn.*``, ``datasets.*`` and
``pipelines.utils``. At the repository root those names are the JAX
package's shims, so the port's tree lives here, file for file the same
modules, re-exporting the port's classes. ``reference_paths`` makes the
three top-level names resolve to it for the length of a ``with`` block, and
``run_script`` runs an unmodified script as ``__main__`` inside one:

    with reference_paths(device="cpu"):
        from multimodn.multimodn import MultiModN     # the port's

    python -m multimodn_tpu_torch.compat script.py [--device cpu] -- -e 5

The torch objects such a body builds (``torch.optim.Adam(list(
model.parameters()), lr)``, ``nn.CrossEntropyLoss()``, ``DataLoader``) are
mapped at the model's entry points (``interop``). A ``MultiModN`` that a body
builds without a device runs on the device the context names, the card by
default.
"""
from __future__ import annotations

import contextlib
import contextvars
import importlib
import importlib.abc
import importlib.machinery
import importlib.util
import runpy
import sys
from typing import Iterator, Optional, Sequence

# The reference's top-level packages this tree stands in for.
NAMES = ("multimodn", "datasets", "pipelines")

_device: contextvars.ContextVar = contextvars.ContextVar(
    "reference_device", default=None)


def default_device():
    """The device ``reference_paths`` names, or None (the card)."""
    return _device.get()


def _owned(name: str) -> bool:
    return name.partition(".")[0] in NAMES


class _AliasLoader(importlib.abc.Loader):
    """Loads a reference name as the module of this tree behind it: the
    same module object, under its own name, so pickles and classes keep
    the port's module paths."""

    def __init__(self, target: str):
        self.target = target
        self._spec = None

    def create_module(self, spec):
        module = importlib.import_module(self.target)
        self._spec = module.__spec__
        return module

    def exec_module(self, module):
        # The import system stamped the alias spec on the module; give the
        # module back its own.
        module.__spec__ = self._spec


class _Finder(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if not _owned(fullname):
            return None
        real = f"{__name__}.{fullname}"
        if importlib.util.find_spec(real) is None:
            # Not in this tree: the parent's path lies in this tree too, so
            # the import ends in ModuleNotFoundError, never in the JAX shims.
            return None
        return importlib.machinery.ModuleSpec(fullname, _AliasLoader(real))


@contextlib.contextmanager
def reference_paths(device=None) -> Iterator[None]:
    """For the block, ``multimodn``, ``datasets`` and ``pipelines`` (and
    their submodules) import from this tree, and a ``MultiModN`` built
    without a device runs on ``device`` (the card when None). Whatever
    ``sys.modules`` held under those names before (the JAX shims, say) is
    put back on exit, and what the block imported under them is dropped."""
    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if _owned(k)}
    finder = _Finder()
    sys.meta_path.insert(0, finder)
    token = _device.set(device)
    try:
        yield
    finally:
        _device.reset(token)
        sys.meta_path.remove(finder)
        for k in [k for k in sys.modules if _owned(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


def run_script(path: str, argv: Sequence[str] = (), device=None) -> dict:
    """Run the script at ``path`` as ``__main__`` with ``sys.argv = [path,
    *argv]`` under ``reference_paths(device)``; returns its globals.
    ``sys.argv`` and ``sys.path`` are restored afterwards."""
    argv_saved, path_saved = sys.argv, list(sys.path)
    sys.argv = [path, *argv]
    try:
        with reference_paths(device):
            return runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = argv_saved
        sys.path[:] = path_saved


def main(argv: Optional[Sequence[str]] = None) -> None:
    """``python -m multimodn_tpu_torch.compat script.py [--device DEV] --
    args...``: the script's own arguments follow ``--``."""
    import argparse

    argv = list(sys.argv[1:] if argv is None else argv)
    ours, rest = (argv[:argv.index("--")], argv[argv.index("--") + 1:]) \
        if "--" in argv else (argv, [])
    p = argparse.ArgumentParser(
        prog="python -m multimodn_tpu_torch.compat",
        description="Run a reference pipeline script against the port.")
    p.add_argument("script")
    p.add_argument("--device", default=None,
                   help="device of models built without one (default: the "
                        "card)")
    args = p.parse_args(ours)
    run_script(args.script, rest, args.device)
