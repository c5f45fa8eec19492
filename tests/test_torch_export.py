"""Ahead-of-time artifacts: the port's ``export_compiled`` /
``load_compiled`` against the JAX package's on the CPU.

The same weights (transplanted from the JAX model) go through both
packages' ``export_compiled``; each artifact is loaded by its package's
``load_compiled`` and fed the same numpy batches. Outputs agree within
1e-5: XLA's and PyTorch's CPU products sum in different orders (~1e-7
relative) through at most two encoders and a decoder. Cases: every
``nan_skip`` mode (for 'batch', one request holding a NaN and one without),
the scan chain, a permuted ``encoder_sequence`` over unequal widths, and a
``StaticInitState`` (phase 0 whatever the model's cycle), each at b = 1
and 32. The port's artifact also loads in a process that imports only
torch.
"""
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import multimodn_tpu as jmm
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
from multimodn_tpu.serving import export_compiled as jexport
from multimodn_tpu.serving import load_compiled as jload
import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc

ATOL = 1e-5
BATCHES = (1, 32)
BANK = np.random.default_rng(9).normal(size=(3, 4)).astype(np.float32)


def _models(case):
    """(JAX model, port model with its weights, encoder_sequence)."""
    kw, seq = {}, None
    if case == "scan":
        enc = lambda mm: [mm.MLPFeatureEncoder(4, 4) for _ in range(3)]
        kw = {"chain_mode": "scan"}
    elif case == "permuted":
        enc = lambda mm: [mm.MLPEncoder(4, 5, (6,)),
                          mm.MIMICMLPEncoder(4, 7, (6,), dropout=0.0)]
        seq = [1, 0]
    else:
        enc = lambda mm: [mm.MLPEncoder(4, 5, (6,)),
                          mm.MIMICMLPEncoder(4, 3, (6,), dropout=0.0)]
    nan_skip = case if case in ("none", "sample", "batch") else "sample"
    models = []
    for mm, encs, decs, extra in ((jmm, jenc, jdec, {}),
                                  (tmm, tenc, tdec, {"device": "cpu"})):
        init = mm.StaticInitState(list(BANK)) if case == "static" else None
        decoders = [decs.MLPDecoder(4, (6,), 2), decs.LogisticDecoder(4)]
        models.append(mm.MultiModN(
            4, enc(encs), decoders, 1.0, 0.2, nan_skip=nan_skip,
            init_state=init, seed=3, **kw, **extra))
    models[1].load_state_dict(models[0].state_dict())
    return models[0], models[1], seq


def _requests(widths, b, seed):
    """One request with NaN cells (whole rows and single entries) and one
    without, ``b`` rows each."""
    rng = np.random.default_rng(seed)
    clean = [rng.normal(size=(b, w)).astype(np.float32) for w in widths]
    holed = [x.copy() for x in clean]
    for m, x in enumerate(holed):
        rows = rng.choice(b, size=max(1, b // 4), replace=False)
        x[rows] = np.nan
        x[(rows[0] + 1) % b, m % x.shape[1]] = np.nan
    return clean, holed


@pytest.mark.parametrize("case", ["none", "sample", "batch", "scan",
                                  "permuted", "static"])
def test_artifact_matches_jax(case, tmp_path):
    jm, tm, seq = _models(case)
    if case == "static":
        tm.predict([np.zeros((2, w), np.float32) for w in (5, 3)])
        assert tm._cycle_offset == 2     # exported at phase 0 all the same
    jrun = jload(jexport(jm, str(tmp_path / "jax.hlo"), platforms=("cpu",),
                         encoder_sequence=seq))
    trun = tmm.load_compiled(tmm.export_compiled(
        tm, str(tmp_path / "port.pt2"), encoder_sequence=seq),
        device="cpu")
    order = tm._resolve_order(None, seq)
    widths = [tm.encoders[e].n_features for _d, e in order]
    for b in BATCHES:
        for x in _requests(widths, b, seed=b):
            want = [np.asarray(o) for o in jrun(*x)]
            got = trun(*x)
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                assert g.shape == w.shape == (len(order) + 1, b, 2)
                np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)
                if case != "none":
                    assert np.isfinite(g.numpy()).all()


def test_batch_skip_is_decided_on_the_data(tmp_path):
    """Under nan_skip='batch' one artifact serves a batch with a NaN (every
    sample keeps its state at that step) and a batch without (the step
    runs): the decision is in the program, not baked in from the example."""
    _, tm, _ = _models("batch")
    run = tmm.load_compiled(tmm.export_compiled(
        tm, str(tmp_path / "batch.pt2")), device="cpu")
    clean, holed = _requests((5, 3), 8, seed=1)
    holed = [clean[0], clean[1].copy()]
    holed[1][3, 0] = np.nan
    got_clean, got_holed = run(*clean)[0], run(*holed)[0]
    # One decoder product over all E+1 rows: equal states may round apart
    # by an ulp in different rows.
    torch.testing.assert_close(got_holed[2], got_holed[1], rtol=0,
                               atol=1e-6)
    assert (got_clean[2] - got_clean[1]).abs().max() > 1e-3
    want = tm.predict_proba(clean)[0]
    np.testing.assert_allclose(got_clean.numpy(), want, atol=1e-6, rtol=0)


def test_widths_follow_the_pairing(tmp_path):
    """Modality d takes the width of the encoder the sequence pairs with
    it: position-order widths do not run (JAX test_serving.py:306)."""
    _, tm, seq = _models("permuted")
    run = tmm.load_compiled(tmm.export_compiled(
        tm, str(tmp_path / "perm.pt2"), encoder_sequence=seq), device="cpu")
    assert run(np.zeros((4, 7), np.float32),
               np.zeros((4, 5), np.float32))[0].shape == (3, 4, 2)
    with pytest.raises(Exception):
        run(np.zeros((4, 5), np.float32), np.zeros((4, 7), np.float32))


def test_artifact_loads_with_torch_alone(tmp_path):
    """The file is the whole program: a process that imports torch and
    blocks this package and JAX runs it and gets the same outputs."""
    _, tm, _ = _models("sample")
    path = tmm.export_compiled(tm, str(tmp_path / "alone.pt2"))
    x = _requests((5, 3), 6, seed=2)[1]
    np.savez(tmp_path / "x.npz", *x)
    want = tmm.load_compiled(path, device="cpu")(*x)
    script = textwrap.dedent("""
        import sys
        for name in ("jax", "multimodn_tpu", "multimodn_tpu_torch"):
            sys.modules[name] = None
        import numpy as np, torch
        path, data, out = sys.argv[1:]
        with np.load(data) as f:
            x = [torch.from_numpy(f[f"arr_{i}"]) for i in range(len(f))]
        outs = torch.export.load(path).module()(*x)
        np.savez(out, *[o.detach().numpy() for o in outs])
        leaked = [k for k in sys.modules if k.split(".")[0] in
                  ("jax", "multimodn_tpu", "multimodn_tpu_torch")
                  and sys.modules[k] is not None]
        assert not leaked, leaked
    """)
    proc = subprocess.run(
        [sys.executable, "-c", script, path, str(tmp_path / "x.npz"),
         str(tmp_path / "out.npz")], capture_output=True, text=True,
        timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(tmp_path / "out.npz") as f:
        for i, w in enumerate(want):
            np.testing.assert_array_equal(f[f"arr_{i}"], w.numpy())


def test_load_compiled_defaults_to_cuda(tmp_path, monkeypatch):
    _, tm, _ = _models("sample")
    path = tmm.export_compiled(tm, str(tmp_path / "m.pt2"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmm.load_compiled(path)


def test_export_guards(tmp_path):
    _, tm, _ = _models("sample")
    with pytest.raises(ValueError, match="tpu"):
        tmm.export_compiled(tm, str(tmp_path / "m.pt2"),
                            platforms=("cpu", "tpu"))
    tm.encoders[0].n_features = None
    with pytest.raises(ValueError, match="n_features"):
        tmm.export_compiled(tm, str(tmp_path / "m.pt2"))


def test_artifact_holds_no_noop_casts(tmp_path):
    """The saved program keeps no cast to a dtype its tensor already has,
    no metadata assert and no unused operation (the training chain's
    state-change terms): each would cost a dispatch per request."""
    _, tm, _ = _models("sample")
    program = torch.export.load(tmm.export_compiled(
        tm, str(tmp_path / "m.pt2")))
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    aten = torch.ops.aten
    assert aten._assert_tensor_metadata.default not in targets
    assert aten.to.dtype not in targets
    assert aten.pow.Tensor_Scalar not in targets
    assert all(n.users or n.op == "output" for n in program.graph.nodes
               if n.op == "call_function")
