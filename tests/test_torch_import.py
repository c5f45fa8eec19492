"""The port stands alone: it imports and trains without JAX, without the
JAX package and without pandas, and its entry points never move work to the
CPU unasked."""
import ast
import importlib
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
    # core, encoders, decoders, data, ops and their modules, model, optim,
    # serving, ...
    assert int(proc.stdout.strip()) >= 25


def test_cpu_training_needs_neither_jax_nor_pandas():
    """Importing every module and training on the CPU (train_epoch with
    Adam8bit, fit_best with Adam, test) loads no JAX, nothing of the JAX
    package and no pandas, and builds no kernel."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["pandas"] = None       # any `import pandas` now fails
        import numpy as np
        import multimodn_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        from multimodn_tpu_torch import encoders, decoders
        from multimodn_tpu_torch.data import ArrayLoader, PartitionDataset
        from multimodn_tpu_torch.ops import fused_adam
        import multimodn_tpu_torch.parallel
        from multimodn_tpu_torch.parallel import make_mesh, batch_sharding, \
            replicate, shard_params, shard_opt_state
        rng = np.random.default_rng(0)
        X = rng.normal(size=(40, 7)).astype(np.float32)
        X[::5, :3] = np.nan
        y = (X[:, 4] > 0).astype(np.int64)
        loader = ArrayLoader(PartitionDataset(X, y, [3, 4]), 16)
        model = pkg.MultiModN(
            4, [encoders.MIMICMLPEncoder(4, w, (5,)) for w in (3, 4)],
            [decoders.MLPDecoder(4, (5,), 2)], 1.0, 0.1, device="cpu")
        hist = pkg.MultiModNHistory(["y"])
        model.train_epoch(loader, pkg.Adam8bit(0.01), "cross_entropy", hist)
        best = model.fit_best(loader, pkg.Adam(0.01), epochs=2,
                              val_loader=loader, history=hist)
        res = model.test(loader, history=hist)
        assert np.isfinite(hist.loss["train"][-1]).all(), hist.loss
        assert best["epochs_ran"] == 2 and len(res) == 1
        assert fused_adam.FUSED_ADAM._lib is None
        leaked = sorted(k for k in sys.modules
                        if k == "multimodn_tpu"
                        or k.startswith("multimodn_tpu."))
        assert not leaked, leaked
        assert sys.modules["jax"] is None and sys.modules["pandas"] is None
        assert "sklearn" not in sys.modules
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_encoding_orders_train_without_jax():
    """The traced chains (``core/scan_chain.py``) load and train without
    JAX or the JAX package: ``shuffle_mode`` on the scan and switch chains,
    per-batch dataset sequences and a repeated static order, on the
    CPU."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["multimodn_tpu"] = None
        import numpy as np
        import multimodn_tpu_torch as pkg
        from multimodn_tpu_torch.core import scan_chain
        from multimodn_tpu_torch import encoders, decoders
        from multimodn_tpu_torch.data import ArrayLoader, PartitionDataset
        rng = np.random.default_rng(0)
        X = rng.normal(size=(24, 9)).astype(np.float32)
        X[::4, :3] = np.nan
        y = (X[:, 4] > 0).astype(np.int64)
        seqs = np.repeat(np.stack([rng.permutation(3) for _ in range(3)]),
                         8, axis=0)

        class Sequenced(PartitionDataset):
            def arrays(self):
                xs, t, _ = super().arrays()
                return xs, t, seqs

        def model(encs, **kw):
            return pkg.MultiModN(4, encs, [decoders.MLPDecoder(4, (5,), 2)],
                                 1.0, 0.1, device="cpu", **kw)

        same = lambda: [encoders.MIMICMLPEncoder(4, 3, (5,)) for _ in "abc"]
        mixed = lambda: [encoders.MIMICMLPEncoder(4, 3, (5,)),
                         encoders.MLPEncoder(4, 3, (5,)),
                         encoders.MIMICMLPEncoder(4, 3, (6,))]
        plain = ArrayLoader(PartitionDataset(X, y, [3, 3, 3]), 8)
        runs = [(model(same(), shuffle_mode=True), plain, "scan"),
                (model(mixed(), shuffle_mode=True), plain, "switch"),
                (model(mixed()), ArrayLoader(Sequenced(X, y, [3, 3, 3]), 8),
                 "unrolled")]
        for m, loader, chain in runs:
            assert m._chain_plan()[0] == chain
            h = pkg.MultiModNHistory(["y"])
            m.fit(loader, pkg.Adam8bit(0.01), epochs=2, history=h)
            assert np.isfinite(h.loss["train"][-1]).all()
        states = runs[2][0].predict([X[:, :3]] * 3, encoder_sequence=[1, 1])
        assert states.shape == (4, 1, 24)
        leaked = sorted(k for k in sys.modules
                        if k.startswith("multimodn_tpu.") or k == "jax.numpy")
        assert not leaked, leaked
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_mimic_pipelines_run_without_jax_pandas_or_sklearn(tmp_path):
    """One epoch of each of the port's three MIMIC pipelines on the CPU at
    a tiny size, in a process where importing jax, the JAX package, pandas
    or scikit-learn fails."""
    script = textwrap.dedent("""
        import os, sys
        for name in ("jax", "multimodn_tpu", "pandas", "sklearn"):
            sys.modules[name] = None       # any import of them now fails
        from multimodn_tpu_torch.data import mimic
        mimic.DEFAULT_CACHE_ROOT = os.path.join(sys.argv[1], "cache")
        os.environ["MULTIMODN_STORAGE"] = os.path.join(sys.argv[1], "store")
        from multimodn_tpu_torch.pipelines.mimic import (
            common, mimic_multi_task_pipeline as multi,
            mimic_single_task_mnar_missingness_pipeline as mnar,
            mimic_single_task_pipeline as single)
        rows = []
        for main, argv in ((single.main, ["-e", "1"]),
                           (multi.main, ["-e", "1"]),
                           (mnar.main, ["-e", "1", "-p", "50"])):
            cfg = common.MimicConfig(sources=["de", "vd", "ts_ce"], nfold=2,
                                     synthetic_patients=24)
            rows.append(len(main(argv, cfg, device="cpu")))
        assert rows == [8, 8, 16], rows
        leaked = sorted(k for k in sys.modules if k.split(".")[0] in
                        ("jax", "multimodn_tpu", "pandas", "sklearn")
                        and sys.modules[k] is not None)
        assert not leaked, leaked
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env={**os.environ,
                                            "MULTIMODN_MIMIC_EMBED_PATH": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_mnar_protocol_and_transformer_run_without_jax_pandas_or_sklearn(
        tmp_path):
    """The MNAR protocol runner (two levels, sample + lambda 25) and the
    transformer pipeline for one epoch on the CPU at a tiny size, in a
    process where importing jax, the JAX package, pandas or scikit-learn
    fails."""
    script = textwrap.dedent("""
        import os, sys
        for name in ("jax", "multimodn_tpu", "pandas", "sklearn"):
            sys.modules[name] = None       # any import of them now fails
        from multimodn_tpu_torch.data import mimic
        mimic.DEFAULT_CACHE_ROOT = os.path.join(sys.argv[1], "cache")
        os.environ["MULTIMODN_STORAGE"] = os.path.join(sys.argv[1], "store")
        from multimodn_tpu_torch.pipelines.mimic import (
            common, mimic_transformer_pipeline as transformer,
            mnar_protocol as proto)
        proto.MISS_PERCS = (0.0, 100.0)
        summary = proto.main(patients=24, epochs=1, nfold=2,
                             nan_skip="sample", presence_penalty=25.0,
                             device="cpu")
        assert list(summary["count"]) == [4] * 6, summary
        cfg = common.MimicConfig(sources=["de", "vd", "ts_ce"], nfold=2,
                                 synthetic_patients=24, transformer_embed=8,
                                 transformer_heads=2, transformer_layers=1)
        rows = transformer.main(["-e", "1"], cfg, device="cpu")
        assert len(rows) == 8, rows
        leaked = sorted(k for k in sys.modules if k.split(".")[0] in
                        ("jax", "multimodn_tpu", "pandas", "sklearn")
                        and sys.modules[k] is not None)
        assert not leaked, leaked
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env={**os.environ,
                                            "MULTIMODN_MIMIC_EMBED_PATH": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_streamed_resumable_pipeline_runs_without_jax_pandas_or_sklearn(
        tmp_path):
    """The single-task pipeline with stream_folds and resume_dir (run twice:
    the second run resumes finished folds), fit_best_resumable with
    Adam8bit, and a CSV streamed through the native bridge, in a process
    where importing jax, the JAX package, pandas or scikit-learn fails."""
    script = textwrap.dedent("""
        import os, sys
        for name in ("jax", "multimodn_tpu", "pandas", "sklearn"):
            sys.modules[name] = None       # any import of them now fails
        import numpy as np
        import multimodn_tpu_torch as tmm
        from multimodn_tpu_torch import checkpoint, decoders, encoders
        from multimodn_tpu_torch.data import (ArrayLoader, CSVStreamingLoader,
                                              PartitionDataset, mimic,
                                              train_epoch_streaming)
        work = sys.argv[1]
        mimic.DEFAULT_CACHE_ROOT = os.path.join(work, "cache")
        from multimodn_tpu_torch.pipelines.mimic import (
            common, mimic_single_task_pipeline as single)
        rows = []
        for run in ("first", "again"):
            os.environ["MULTIMODN_STORAGE"] = os.path.join(work, run)
            cfg = common.MimicConfig(sources=["de", "vd", "ts_ce"], nfold=2,
                                     synthetic_patients=24, stream_folds=True,
                                     resume_dir=os.path.join(work, "ck"))
            rows.append(single.main(["-e", "2"], cfg, device="cpu"))
        assert rows[0] == rows[1] and len(rows[0]) == 8, rows
        X = np.random.default_rng(0).normal(size=(30, 5)).astype(np.float32)
        y = (X[:, 0] > 0).astype(np.int64)
        ds = PartitionDataset(X, y, [2, 3])
        model = tmm.MultiModN(4, [encoders.MIMICMLPEncoder(4, w, (5,))
                                  for w in (2, 3)],
                              [decoders.MLPDecoder(4, (5,), 2)], 1.0, 0.0,
                              device="cpu")
        checkpoint.fit_best_resumable(
            model, ArrayLoader(ds, 8), tmm.Adam8bit(0.01), epochs=2,
            checkpoint_dir=os.path.join(work, "fit"),
            val_loader=ArrayLoader(ds, 8), chunk_epochs=1)
        path = os.path.join(work, "m.csv")
        with open(path, "w") as f:
            f.write("a,b,c,d,e,t\\n")
            for row, t in zip(X, y):
                f.write(",".join(map(repr, map(float, row))) + f",{t}\\n")
        train_epoch_streaming(model, CSVStreamingLoader(path, [2, 3], 1, 8),
                              tmm.Adam8bit(0.01))
        leaked = sorted(k for k in sys.modules if k.split(".")[0] in
                        ("jax", "multimodn_tpu", "pandas", "sklearn")
                        and sys.modules[k] is not None)
        assert not leaked, leaked
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env={**os.environ,
                                            "MULTIMODN_MIMIC_EMBED_PATH": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_reference_body_runs_without_jax_pandas_sklearn_tqdm_or_matplotlib(
        tmp_path):
    """Importing ``multimodn_tpu_torch.compat`` and running the
    reference-idiom quick-start under ``reference_paths`` (through
    ``run_script``, with ``-p false``) on the CPU, in a process where
    importing jax, the JAX package, the repo root's shims, pandas,
    scikit-learn, tqdm or matplotlib fails."""
    script = textwrap.dedent("""
        import os, pickle, shutil, sys
        blocked = ("jax", "multimodn_tpu", "pandas", "sklearn", "tqdm",
                   "matplotlib")
        for name in blocked:
            sys.modules[name] = None       # any import of them now fails
        from multimodn_tpu_torch import compat
        work = sys.argv[1]
        path = os.path.join(work, "titanic_mlp_pipeline.py")
        shutil.copy(os.path.join(os.path.dirname(compat.__file__),
                                 "examples", "titanic_mlp_pipeline.py"), path)
        compat.run_script(path, ["-e", "2", "-p", "false"], device="cpu")
        with open(os.path.join(work, "models",
                               "titanic_mlp_history.pkl"), "rb") as f:
            assert len(pickle.load(f).loss["train"]) == 2
        assert os.path.exists(os.path.join(work, "results",
                                           "titanic_mlp.csv"))
        leaked = sorted(k for k in sys.modules
                        if k.split(".")[0] in blocked + compat.NAMES
                        and sys.modules[k] is not None)
        assert not leaked, leaked
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def _jax_all(subpackage: str) -> list:
    """A JAX ``__init__.py``'s ``__all__``, read as text, so this process
    never imports JAX."""
    path = os.path.join(ROOT, "multimodn_tpu", subpackage, "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no __all__")


@pytest.mark.parametrize("subpackage", ["", "encoders", "decoders", "data",
                                        "baselines", "parallel"])
def test_every_jax_export_imports_from_the_port(subpackage):
    """Each name of the JAX package's ``__all__`` imports from the port's
    module of the same name."""
    module = importlib.import_module(
        "multimodn_tpu_torch" + ("." + subpackage if subpackage else ""))
    missing = [n for n in _jax_all(subpackage) if not hasattr(module, n)]
    assert not missing, missing


def test_experiments_and_serving_artifacts_run_without_jax_or_pandas(
        tmp_path):
    """The experiment surface and the ahead-of-time artifacts on the CPU, in
    a process where importing jax, the JAX package, pandas or scikit-learn
    fails: a streamed seed sweep with ``Adam8bit`` and ``on_epoch``,
    ``fold_history``, ``export_compiled`` -> ``load_compiled``, a profiler
    trace, and the production-features example."""
    script = textwrap.dedent("""
        import os, sys
        for name in ("jax", "multimodn_tpu", "pandas", "sklearn"):
            sys.modules[name] = None       # any import of them now fails
        import numpy as np
        import multimodn_tpu_torch as pkg
        from multimodn_tpu_torch import decoders, encoders, experiments
        from multimodn_tpu_torch.data import PartitionDataset, \
            StreamingLoader
        from multimodn_tpu_torch.examples import production_features
        from multimodn_tpu_torch.utils import profiling
        X = np.random.default_rng(0).normal(size=(40, 5)).astype(np.float32)
        y = (X[:, 0] > 0).astype(np.int64)
        ds = PartitionDataset(X, y, [2, 3])

        def factory(seed):
            return pkg.MultiModN(4, [encoders.MIMICMLPEncoder(4, w, (5,))
                                     for w in (2, 3)],
                                 [decoders.MLPDecoder(4, (5,), 2)], 1.0, 0.0,
                                 seed=seed, device="cpu")

        seen = []
        with profiling.trace(sys.argv[1]):
            res = experiments.sweep_fit_best(
                factory, StreamingLoader(ds, 8), StreamingLoader(ds, 8),
                pkg.Adam8bit(0.01), epochs=2, seeds=[0, 1],
                on_epoch=seen.append)
        assert len(seen) == 4 and len(res) == 2, seen
        hist = experiments.fold_history(res[0], ["y"])
        assert len(hist.loss["val"]) == 2
        path = pkg.export_compiled(res[0]["model"],
                                   os.path.join(sys.argv[1], "m.pt2"))
        outs = pkg.load_compiled(path, device="cpu")(X[:3, :2], X[:3, 2:])
        assert outs[0].shape == (3, 3, 2)
        production_features.main("cpu")
        leaked = sorted(k for k in sys.modules if k.split(".")[0] in
                        ("jax", "multimodn_tpu", "pandas", "sklearn")
                        and sys.modules[k] is not None)
        assert not leaked, leaked
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmm.opt_state_from_jax(tmm.Adam(0.1).init(model.params))
    assert tmm.load_model(str(tmp_path), device="cpu").device.type == "cpu"


def test_cpu_wrapper_runs_the_plain_version_without_launching():
    model = _model(device="cpu")
    before = fc.FUSED_CHAIN.launches
    states, outs = model.fused_forward(
        [np.random.default_rng(0).normal(size=(3, 3)).astype(np.float32)])
    assert states.shape == (2, 3, 4) and outs[0].shape == (2, 3, 2)
    assert fc.FUSED_CHAIN.launches == before
    assert fc.FUSED_CHAIN._lib is None       # nothing was built
