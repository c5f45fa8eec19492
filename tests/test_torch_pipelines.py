"""The port's MIMIC experiment protocol against the JAX package on the CPU:
``kfold_fit_best`` (unequal fold batch counts, ``patience``) and the state
it leaves each fold's model in, the three pipeline ``main``s against the
JAX scripts' results CSVs, ``append_result_row`` against pandas, the
checkpoint files of both packages, and the fold-mesh guard.

Weights are transplanted from the JAX package (``load_state_dict``) and
dropout is 0 wherever trajectories are compared: JAX threefry and torch
Philox draw different masks. Tolerances: XLA's and PyTorch's CPU matrix
products sum in different orders (~1e-7 relative), which stays at float32
rounding over a few epochs of Adam: parameters, optimizer moments, loss sums
and selection scores agree to atol 1e-5 (loss sums to 1e-4: they add ~100
per-sample terms), ``best_epoch``, epoch counts and confusion counts
exactly. In the pipelines' CSVs the hyper-parameter columns and the
confusion counts must be equal and every AUROC within 1e-6 (a test AUROC
moves only if two test samples' scores swap order).
"""
import csv
import os

import numpy as np
import pytest

import multimodn_tpu as jmm
from multimodn_tpu import decoders as jdec
from multimodn_tpu import encoders as jenc
from multimodn_tpu.baselines.haim import HAIM as JHAIM
from multimodn_tpu.baselines.haim import HAIMDecoder as JHAIMDecoder
from multimodn_tpu.data import ArrayLoader as JLoader
from multimodn_tpu.data import PartitionDataset as JDataset
from multimodn_tpu.experiments import kfold_fit_best as jkfold
import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.convert import opt_state_from_jax
from multimodn_tpu_torch.core.tree import tree_leaves
from multimodn_tpu_torch.data import ArrayLoader as TLoader
from multimodn_tpu_torch.data import PartitionDataset as TDataset
from multimodn_tpu_torch.data import mimic as tmimic
from multimodn_tpu_torch.experiments import kfold_fit_best as tkfold
from multimodn_tpu_torch.experiments import sweep_fit_best as tsweep
from multimodn_tpu_torch.pipelines import utils as tutils
from multimodn_tpu_torch.pipelines.mimic import common as tcommon

ATOL = 1e-5
WIDTHS, S = (5, 9, 4), 6
COUNT_KEYS = ("n_correct", "tp", "tn", "fp", "fn", "n_counted")


def _factories(static_bank=None):
    def init_state(mod):
        return None if static_bank is None else \
            mod.StaticInitState(list(static_bank))

    def jfactory(seed):
        return jmm.MultiModN(
            S, [jenc.MIMICMLPEncoder(S, w, (8,), dropout=0.0)
                for w in WIDTHS],
            [jdec.MLPDecoder(S, (8,), 2) for _ in range(2)], 1.0, 0.5,
            seed=seed, init_state=init_state(jmm))

    def tfactory(seed):
        model = tmm.MultiModN(
            S, [tenc.MIMICMLPEncoder(S, w, (8,), dropout=0.0)
                for w in WIDTHS],
            [tdec.MLPDecoder(S, (8,), 2) for _ in range(2)], 1.0, 0.5,
            seed=seed, init_state=init_state(tmm), device="cpu")
        model.load_state_dict(jfactory(seed).state_dict())
        return model

    return jfactory, tfactory


def _fold_loaders(sizes, seed=0):
    """Per fold (train, val) loader pairs for both packages, with unequal
    batch counts across folds and ~20% of modality cells NaN."""
    rng = np.random.default_rng(seed)
    jfolds, tfolds = [], []
    for n_train, n_val in sizes:
        pair_j, pair_t = [], []
        for n in (n_train, n_val):
            X = rng.normal(size=(n, sum(WIDTHS))).astype(np.float32)
            X[rng.random(n) < 0.2, :WIDTHS[0]] = np.nan
            y = np.stack([X[:, 6:9].sum(1) > 0, X[:, -2:].sum(1) > 0], 1) \
                .astype(np.int64)
            pair_j.append(JLoader(JDataset(X, y, list(WIDTHS)), 16))
            pair_t.append(TLoader(TDataset(X, y, list(WIDTHS)), 16))
        jfolds.append(tuple(pair_j))
        tfolds.append(tuple(pair_t))
    return jfolds, tfolds


@pytest.mark.parametrize("patience", [None, 1])
def test_kfold_fit_best_matches_jax(patience):
    jfactory, tfactory = _factories()
    jfolds, tfolds = _fold_loaders([(40, 20), (70, 23), (33, 30)])
    kw = dict(epochs=5, seeds=[3, 4, 5], patience=patience)
    want = jkfold(jfactory, jfolds, jmm.Adam(1e-2), "cross_entropy", **kw)
    got = tkfold(tfactory, tfolds, tmm.Adam(1e-2), "cross_entropy", **kw)
    assert len(got) == len(want) == 3
    assert [g["n_train_batches"] for g in got] == [3, 5, 3]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["best_epoch"] == w["best_epoch"]
        assert g["epochs_ran"] == w["epochs_ran"]
        assert g["n_train_batches"] == w["n_train_batches"]
        assert g["n_val_batches"] == w["n_val_batches"]
        assert g["best_score"] == pytest.approx(w["best_score"], abs=ATOL)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=ATOL)
        for key in ("train_sums", "val_sums"):
            assert sorted(g[key]) == sorted(w[key])
            for k, v in w[key].items():
                assert g[key][k].shape == np.shape(v), (key, k)
                if k in COUNT_KEYS:
                    np.testing.assert_array_equal(g[key][k], v)
                else:
                    np.testing.assert_allclose(g[key][k], v, atol=1e-4)
        for a, b in zip(tree_leaves(g["model"].state_dict()),
                        tree_leaves(tmm.params_from_jax(
                            w["model"].state_dict(), "cpu"))):
            np.testing.assert_allclose(a, b.numpy(), atol=ATOL, rtol=0)
    if patience is not None:
        assert any(g["epochs_ran"] < 5 for g in got)


def test_kfold_leaves_each_model_as_jax_does():
    """Best parameters loaded, the init-state cycle and the epoch counter
    advanced by the epochs run, and the fold's trained optimizer state kept:
    a later test() or training step continues from there."""
    bank = np.random.default_rng(1).normal(size=(5, S)).astype(np.float32)
    jfactory, tfactory = _factories(static_bank=bank)
    jfolds, tfolds = _fold_loaders([(40, 21), (55, 17)], seed=2)
    jopt, topt = jmm.Adam(1e-2), tmm.Adam(1e-2)
    want = jkfold(jfactory, jfolds, jopt, epochs=3, seeds=[0, 1],
                  patience=2)
    got = tkfold(tfactory, tfolds, topt, epochs=3, seeds=[0, 1], patience=2)
    for f, (g, w) in enumerate(zip(got, want)):
        gm, wm = g["model"], w["model"]
        assert gm._cycle_offset == int(wm._cycle_offset)
        assert gm._epoch_counter == wm._epoch_counter == g["epochs_ran"]
        assert gm._opt is topt and wm._opt is jopt
        want_state = opt_state_from_jax(wm.opt_state, "cpu")
        assert gm.opt_state["t"].item() == want_state["t"].item()
        for a, b in zip(tree_leaves([gm.opt_state["m"], gm.opt_state["v"]]),
                        tree_leaves([want_state["m"], want_state["v"]])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)
        # A test pass from the returned model agrees, cycle phase included.
        tres = gm.test(tfolds[f][1])
        wres = wm.test(jfolds[f][1])
        for tr, wr in zip(tres, wres):
            assert tr[1] == pytest.approx(wr[1], abs=1e-6)
            assert tr[9:13] == wr[9:13]


def test_kfold_unported_arguments_raise():
    _, tfactory = _factories()
    _, tfolds = _fold_loaders([(20, 10), (20, 10)])
    opt = tmm.Adam(1e-2)
    # Fold and seed meshes are ported (test_torch_parallel.py); a mesh
    # without the fold axis raises the JAX package's ValueError.
    with pytest.raises(ValueError, match="mesh has no 'fold' axis"):
        tkfold(tfactory, tfolds, opt, mesh=object())
    with pytest.raises(ValueError, match="mesh has no 'fold' axis"):
        tsweep(tfactory, *tfolds[0], opt, mesh=object())
    with pytest.raises(ValueError, match="patience"):
        tkfold(tfactory, tfolds, opt, patience=0)


@pytest.mark.parametrize("row, columns", [
    (["modn", "Cardiomegaly", 0, 0.0, 3, 50, 16, 32, 32, 0.2, 7, 0.5,
      0.7142857142857143, 1.0, 0.0, 1 / 3, [0.0, 0.5, 1.0], [0.0, 1.0],
      [1.0, 0.25], [], 3.0, 1e-05, 1e16, float("nan"), [0.1, 0.2], [0.3]],
     None),
    (["haim", "Enlarged Cardiomediastinum", True, 1, 50.0, 0, 50, 16, 32, 32,
      0.2, 3] + [0.123456789] * 15, "mnar"),
    (["haim", "x,y", None, 1, 0.0, 0, 50, 16, 32, 32, 0.0, 3]
     + [np.float64(0.25), np.float32(0.1), np.int64(4), False, 'q"'] * 3,
     "mnar"),
], ids=["modn", "mnar_both", "odd_values"])
def test_append_result_row_is_byte_identical_to_pandas(tmp_path, row,
                                                       columns):
    from pipelines.mimic import common as jcommon
    from pipelines.mimic.mimic_single_task_mnar_missingness_pipeline import \
        SAVE_LOGS_MNAR
    columns = SAVE_LOGS_MNAR if columns == "mnar" else None
    paths = {}
    for name, mod in (("jax", jcommon), ("port", tcommon)):
        paths[name] = str(tmp_path / f"{name}.csv")
        for _ in range(3):                      # header once, then appends
            mod.append_result_row(paths[name], row, columns=columns)
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        want, got = a.read(), b.read()
    assert got == want
    assert got.count(b"\n") == 4
    with pytest.raises(ValueError, match="columns"):
        tcommon.append_result_row(paths["port"], row[:-1], columns=columns)


def test_metric_scalars_and_config_match_jax():
    from pipelines.mimic import common as jcommon
    from multimodn_tpu.core.metrics import get_performance_metrics
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 30)
    p = rng.random(30)
    suite = get_performance_metrics(y, (p > 0.5).astype(int), p)
    assert tcommon._metric_scalars(suite) == jcommon._metric_scalars(suite)
    assert tcommon.MimicConfig() == tcommon.MimicConfig(
        **vars(jcommon.MimicConfig()))
    assert tcommon.SAVE_LOGS == jcommon.SAVE_LOGS


def test_parse_args_matches_jax():
    from pipelines import utils as jutils
    for argv in ([], ["-e", "3", "-s", "2", "-m", "false", "-r", "no"]):
        assert vars(tutils.parse_args(argv=argv)) == \
            vars(jutils.parse_args(argv=argv))
    assert tutils.extract_pipeline_name(
        "/a/mimic_single_task_pipeline.py") == "mimic_single_task"
    with pytest.raises(Exception, match="Boolean"):
        tutils.string_to_bool("maybe")


@pytest.mark.parametrize("option, match", [
    ({"stream_folds": True}, "fold_tag"),
    ({"resume_dir": "/nonexistent"}, "fold_tag"),
])
def test_unported_pipeline_options_raise(option, match):
    """stream_folds and resume_dir are ported: models build under them, and
    the one refusal left is the JAX package's, a resumable fold without a
    fold_tag (its checkpoints could collide with another run's)."""
    cfg = tcommon.MimicConfig(**{"resume_dir": "/nonexistent", **option})
    assert tcommon.build_modn(cfg, [3, 4], ["t"], 0, device="cpu")
    with pytest.raises(ValueError, match=match):
        tcommon.run_fold_modn(cfg, None, [3, 4], ["t"], [], [], [], 0,
                              device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_files_load_in_both_packages(tmp_path, writer):
    from multimodn_tpu import checkpoint as jckpt
    from multimodn_tpu_torch import checkpoint as tckpt
    jfactory, tfactory = _factories()
    jm, tm = jfactory(7), tfactory(7)
    path = str(tmp_path / "best.pkl")
    (jckpt if writer == "jax" else tckpt).save_checkpoint(
        path, jm if writer == "jax" else tm, 4, 1.25, extra={"fold": 2})
    assert not os.path.exists(path + ".tmp")
    for reader, model in ((jckpt, jfactory(0)), (tckpt, tfactory(0))):
        payload = reader.load_checkpoint(path, model)
        assert payload["epoch"] == 4 and payload["auc_bac_val_cum"] == 1.25
        assert payload["fold"] == 2
        for a, b in zip(tree_leaves(tmm.params_from_jax(model.state_dict(),
                                                        "cpu")),
                        tree_leaves(tm.params)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    hj = JHAIM(JHAIMDecoder(12, (4,)), seed=1)
    tckpt.save_checkpoint(path, tcommon.HAIM(tcommon.HAIMDecoder(12, (4,)),
                                             seed=5, device="cpu"), 0)
    jckpt.load_checkpoint(path, hj)
    assert hj.state_dict()["layers"][0]["w"].shape == (12, 4)
    opt_path = str(tmp_path / "opt.pkl")
    _, tfolds = _fold_loaders([(20, 10)])
    tm.fit(tfolds[0][0], tmm.Adam(1e-2))        # 2 steps
    tckpt.save_checkpoint(opt_path, tm, 1, include_opt_state=True)
    state = tckpt.load_checkpoint(opt_path)["opt_state"]
    assert state["t"] == 2 and [float(t) for t in state["t_enc"]] == [2] * 3
    assert state["m"]["encoders"][0]["layers"][0]["w"].shape == (5 + S, 8)


# --------------------------------------------------------------------------
# The three pipelines against the JAX scripts
# --------------------------------------------------------------------------

def _transplant(monkeypatch, jcfg):
    """Seed the port's MultiModN and HAIM models from the JAX package's
    models of the same configuration and seed."""
    from pipelines.mimic import common as jcommon
    build = tcommon.build_modn

    def build_from_jax(cfg, partitions, targets, seed, device=None):
        model = build(cfg, partitions, targets, seed, device)
        model.load_state_dict(
            jcommon.build_modn(jcfg, partitions, targets, seed).state_dict())
        return model

    class HAIMFromJax(tcommon.HAIM):
        def __init__(self, decoder, seed=0, device=None):
            super().__init__(decoder, seed, device)
            twin = JHAIM(JHAIMDecoder(decoder.n_features,
                                      tuple(decoder._dims[1:-1])), seed=seed)
            self.load_state_dict(twin.state_dict())

    monkeypatch.setattr(tcommon, "build_modn", build_from_jax)
    monkeypatch.setattr(tcommon, "HAIM", HAIMFromJax)


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


# argv, CSV rows, the best checkpoints the port saves under -m (on by
# default; the MNAR script saves none): one per target and fold, and the
# configuration beyond the common one. One epoch each: the JAX scripts'
# compiles take most of these tests' time, and best-epoch selection over
# several epochs is held against JAX in the kfold_fit_best tests above. The
# transformer case runs the JAX single-task script with the configuration
# the JAX transformer script builds (it takes no cfg), at tiny widths.
PIPELINES = {
    "single": ("mimic_single_task_pipeline", ["-e", "1"], 8, 4, {}),
    "multi": ("mimic_multi_task_pipeline", ["-e", "1"], 8, 2, {}),
    "mnar": ("mimic_single_task_mnar_missingness_pipeline",
             ["-e", "1", "-p", "50"], 16, 0, {}),
    "mnar_pp25": ("mimic_single_task_mnar_missingness_pipeline",
                  ["-e", "1", "-p", "50"], 16, 0,
                  {"nan_skip": "sample", "presence_penalty": 25.0}),
    "transformer": ("mimic_transformer_pipeline", ["-e", "1"], 8, 4,
                    {"encoder_type": "transformer", "transformer_embed": 8,
                     "transformer_heads": 2, "transformer_layers": 1,
                     "transformer_chunk": 64}),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_pipeline_csv_matches_jax(tmp_path, monkeypatch, name):
    import importlib
    from pipelines.mimic import common as jcommon
    from multimodn_tpu_torch import checkpoint as tckpt
    module, argv, n_rows, n_saved, extra = PIPELINES[name]
    jmodule = "mimic_single_task_pipeline" if name == "transformer" \
        else module
    jmain = importlib.import_module(f"pipelines.mimic.{jmodule}").main
    tmain = importlib.import_module(
        f"multimodn_tpu_torch.pipelines.mimic.{module}").main
    kw = dict(sources=["de", "vd", "ts_ce"], nfold=2, synthetic_patients=40,
              dropout=0.0, **extra)
    monkeypatch.delenv("MULTIMODN_MIMIC_EMBED_PATH", raising=False)
    monkeypatch.setattr(tmimic, "DEFAULT_CACHE_ROOT", str(tmp_path / "cache"))
    files = {}
    for pkg, run, cfg in (("jax", jmain, jcommon.MimicConfig(**kw)),
                          ("port", tmain, tcommon.MimicConfig(**kw))):
        storage = tmp_path / pkg
        monkeypatch.setenv("MULTIMODN_STORAGE", str(storage))
        if pkg == "port":
            _transplant(monkeypatch, jcommon.MimicConfig(**kw))
            run(argv, cfg, device="cpu")
        else:
            run(argv, cfg)
        results = storage / "nips" / "results"
        (files[pkg],) = os.listdir(results)
        files[pkg] = _read(str(results / files[pkg]))
    (jhead, jrows), (thead, trows) = files["jax"], files["port"]
    assert thead == jhead and len(trows) == len(jrows) == n_rows
    n_hp = jhead.index("f1")
    auc, counts = jhead.index("auc"), [jhead.index(k) for k in
                                       ("tn", "fp", "fn", "tp")]
    for t, j in zip(trows, jrows):
        assert t[:n_hp] == j[:n_hp]
        assert [t[i] for i in counts] == [j[i] for i in counts]
        assert float(t[auc]) == pytest.approx(float(j[auc]), abs=1e-6)
        assert 0.0 <= float(t[auc]) <= 1.0
    saved = sorted(str(p) for p in (tmp_path / "port").rglob("modn_best_*"))
    assert len(saved) == n_saved
    for path in saved:
        assert os.path.basename(path) in ("modn_best_fold0_seed0.pkl",
                                          "modn_best_fold1_seed1.pkl")
        payload = tckpt.load_checkpoint(path)
        assert payload["epoch"] == 0 and np.isfinite(
            payload["auc_bac_val_cum"])
