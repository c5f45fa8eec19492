"""The port stands alone: it imports without JAX and without the JAX
package, and its entry points never move work to the CPU unasked."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.ops import fused_chain as fc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_imports_without_jax_or_the_jax_package():
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any `import jax` now fails
        import multimodn_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(k for k in sys.modules
                        if k == "multimodn_tpu"
                        or k.startswith("multimodn_tpu."))
        assert not leaked, leaked
        assert sys.modules["jax"] is None
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # core, encoders, decoders, ops and their modules, model, serving, ...
    assert int(proc.stdout.strip()) >= 15


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _model(**kw):
    return tmm.MultiModN(4, [tenc.MLPEncoder(4, 3, (5,))],
                         [tdec.LogisticDecoder(4)], 1.0, 0.0, **kw)


def test_entry_points_refuse_to_default_to_cpu(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _model()
    model = _model(device="cpu")
    tmm.export_model(model, str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmm.load_model(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmm.params_from_jax(model.state_dict())
    assert tmm.load_model(str(tmp_path), device="cpu").device.type == "cpu"


def test_cpu_wrapper_runs_the_plain_version_without_launching():
    model = _model(device="cpu")
    before = fc.FUSED_CHAIN.launches
    states, outs = model.fused_forward(
        [np.random.default_rng(0).normal(size=(3, 3)).astype(np.float32)])
    assert states.shape == (2, 3, 4) and outs[0].shape == (2, 3, 2)
    assert fc.FUSED_CHAIN.launches == before
    assert fc.FUSED_CHAIN._lib is None       # nothing was built
