#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``multimodn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --protocol-only --patients 6485 --epochs 1
    python3 chip_smoke.py --protocol-only --stream-folds --patients 6485 --epochs 2
    python3 chip_smoke.py --mnar-only --epochs 10
    python3 chip_smoke.py --orders-only
    python3 chip_smoke.py --dropin-only

The first form is the smoke run; the second times phase 8 alone at another
data size and depth, the third with every fold's batches streamed; the
fourth runs the MNAR protocol grid alone, the fifth phase 13 alone, the
sixth phase 14 alone.
Phases, each fatal on failure:

1. the card's name and power limit, torch and CUDA versions; TF32 off;
2. build the fused-chain kernel from ``multimodn_tpu_torch/csrc``;
3. the fused chain (Stage A and Stage B) against its plain PyTorch
   version at the MIMIC multi-task model (B = 1, 16, 33, 1000, 65536, ~30%
   of modality cells invalid) and at a small last-concat model with
   gelu/tanh encoders and softmax heads: max abs error, kernel and plain
   times (CUDA events), launches per call, the bound, Stage A's blocks, at
   B = 16 and 65536 each stage's device time (``torch.profiler``), and at
   B = 65536 Stage B on its small tiles too;
4. serving: a seeded MIMIC model goes through ``export_model`` ->
   ``load_model`` and answers 8 requests of batch 16 (some with NaN rows)
   through ``fused_forward``; each answer is checked against the plain
   chain, ``InferenceSession`` must reproduce its state rows, and the
   kernels' launch count must equal the requests times the plan's launches
   per request (2 at MIMIC width);
5. the fused 8-bit Adam kernel against its plain PyTorch version through
   ``multi_leaf_update``: every leaf shape of the MIMIC model and (4096,
   1024), (65536,) and a 0-D leaf in one call per code format and gate
   (none, 0, 1), a call mixing three groups with their own bias
   corrections and gates, and a NaN in a row split across blocks, from
   moments of a few prior steps: parameters, codes and scales must be
   bit-equal (a NaN equals a NaN); the kernel's and the plain version's
   times (CUDA events), launches per update, the bound, and the kernel's
   time with each lane layout (one run of 4 elements per lane, or up to
   four);
6. training at full width: ``fit_best`` with ``Adam8bit`` for 3 epochs of
   batch 16 on seeded synthetic MIMIC-width data (30% of modality cells
   missing), then ``test``; every loss finite, the third epoch's training
   loss below the first's, and the fused Adam kernel launched as often per
   step as its leaf table says (once at MIMIC width); the same run with
   ``Adam`` is timed beside it,
   and ``torch.profiler`` splits a few steps into device and host time,
   read from the profiler's device events and, on the same trace, through
   ``key_averages()``;
7. the card against the CPU: the same weights take 3 ``Adam8bit`` steps on
   the same batches on both devices and must agree;
8. the MIMIC protocol: the port's three MIMIC pipelines (single-task, 2
   targets x 5 folds; multi-task, 5 folds; MNAR with 50% missingness) at
   the MIMIC model's full width on the pipelines' default synthetic data
   (120 patients), 3 epochs each, in a temporary directory that holds the
   results CSVs and the data cache. The CSVs must hold 20, 20 and 40 rows,
   every AUROC finite and in [0, 1], every MultiModN and HAIM parameter on
   the card, and neither pandas, scikit-learn, JAX nor the JAX package
   loaded. Each pipeline's wall time splits into data and cache build,
   MultiModN folds and HAIM folds, with training steps per second and the
   cache files' parses (each pipeline starts with no parse kept, as in a
   process of its own). No kernel is on this path (the protocol trains
   with ``Adam`` and tests through the plain chain, as the JAX package's
   does): both launch counters must read 0 after each pipeline;
9. the Titanic quick-start and its pipelines: the port's six Titanic
   pipelines at 5 epochs (the reference's smoke depth) with the results
   CSV written in a temporary directory, plots and pickles off; then the
   quick-start (the titanic_mlp config) for its published 300 epochs of
   ``fit``, then ``test``, the last epoch's training loss below the
   first's; then the trained quick-start, partitioned, featurewise and
   missingness models through ``export_model`` -> ``load_model``, each
   answering its validation set in requests of 16 rows through
   ``fused_forward`` (K1 at state 1, at two partitions, at five and six
   1-feature modalities, with NaN cells in the last), held against the
   plain chain and ``InferenceSession``, with K1's launches counted over
   those requests and K1 timed beside its plain version and its bound.
   Every loss finite, every parameter on the card, no pandas,
   scikit-learn, JAX or JAX package loaded, and no kernel launched while
   training (the pipelines train with ``Adam`` on the plain chain, as the
   JAX package's do); wall times, training steps per second, and a
   ``torch.profiler`` split of 8 steps of the quick-start's and the LSTM
   pipeline's models printed;
10. the MNAR robustness protocol (``pipelines/mimic/mnar_protocol.py``)
   cut to 120 patients, 2 folds and 2 epochs, all six missingness levels,
   for ``nan_skip='batch'`` and for ``'sample'`` with the presence penalty
   (lambda 25), in a temporary directory: 2 targets x 2 folds x (1 or 2
   tests) rows per level and model, the summary's 22 groups, every AUROC
   in [0, 1], no kernel launched, no pandas, scikit-learn or JAX loaded;
   wall time per variant and level, MultiModN and HAIM steps/s. Then a
   MIMIC model trained by ``fit_best`` with ``nan_skip='sample'`` and
   lambda 25 on an 80%-degraded fold goes through ``export_model`` ->
   ``load_model`` and serves its flipped-class test rows through K1,
   launches counted, held against the plain chain;
11. the MIMIC transformer pipeline at full width (a ``TransformerEncoder``
   of embed 128, 4 heads, 2 layers, chunk 64 per source: 1, 16, 12 and 2
   tokens) on 120 patients, 5 folds, 2 epochs: 20 rows, wall time and
   steps/s; a trained model through ``export_model`` -> ``load_model``
   with ``predict_proba`` bit-equal and ``fused_forward`` refused; the
   card against the CPU after 3 ``Adam`` steps for that model and for a
   ``ViTEncoder`` at its constructor defaults; ``torch.profiler`` over 8
   training steps at batch 16 and 1024 (kernels and device ms per step,
   busy share);
12. resumable fits and the streaming and disk loaders at the MIMIC
   model's full width with ``Adam8bit`` (fp8) on phase 6's cohort: two
   child processes (``fit_best_resumable`` on shuffled ArrayLoaders,
   ``fit_best_streaming`` with ``checkpoint_dir``) are SIGKILLed right
   after their first epoch's checkpoint, and each run resumed here must
   equal its uninterrupted run bit for bit (parameters, moment codes as
   uint8, scales, scores, best epoch) with K2 launched once per step of
   the resumed epochs; ``fit_best_streaming`` must equal ``fit_best`` on
   fixed-order ArrayLoaders of the same rows bit for bit; the validation
   split exported by ``export_streaming_matrix`` and written as a CSV
   streams through ``NpyStreamingLoader`` and ``CSVStreamingLoader`` (the
   native bridge built from ``native/*.cpp`` with g++) in the
   StreamingLoader's batches; the single-task MIMIC pipeline (120 patients,
   5 folds, 2 epochs) with ``resume_dir``, invoked again on that finished
   ``resume_dir``, and with ``stream_folds`` writes the default run's
   results CSV byte for byte; the resumed best model goes
   through ``export_model`` -> ``load_model`` and serves 8 requests through
   K1 against the plain chain; training steps/s over ArrayLoader and
   streamed batches of 16 and 1024, the share of the streamed copies'
   device time that overlaps a kernel (``torch.profiler``), and a resume
   payload's write time;
13. encoding orders: the MIMIC model at full width with ``shuffle_mode``
   (the switch chain, an order per training batch) trained by ``fit_best``
   with ``Adam8bit`` for 2 epochs on phase 6's cohort (K2 once per step),
   3 steps on the card against the CPU on the same permutations, and the
   model exported, loaded and serving 8 requests through K1 against the
   plain chain; then the featurewise chain (1901 ``MLPFeatureEncoder(50,
   32)``, one ``MLPDecoder``; 256 seeded rows, 10% NaN, batches of 64)
   trained 2 epochs with ``Adam8bit``, once with ``shuffle_mode`` (the scan
   chain) and once on batches that each carry their own permutation of the
   features: per run one step on the card against the CPU, steps/s, K2
   launches per step (``launches_per_update`` of ~7,600 leaves), a
   ``torch.profiler`` step (kernels, device ms, busy share, K2's own ms)
   and ``predict_proba`` against the CPU; and K2 on those leaves held bit
   for bit against its plain version (every one of its launches), then
   timed beside it and its bytes bound;
14. the drop-in torch surface: the reference-idiom quick-start
   (``multimodn_tpu_torch/compat/examples/titanic_mlp_pipeline.py``: the
   reference's import paths, ``torch.optim.Adam`` over
   ``model.parameters()``, ``nn.CrossEntropyLoss()``, ``DataLoader``s, an
   ``F.relu`` encoder) through ``compat.run_script`` for 20 epochs with
   ``-p false``, its pickled model on the card, its loss falling and its
   results CSV written; the MIMIC model at full width trained 3 epochs with
   ``torch.optim.Adam``, a shuffled ``DataLoader`` and
   ``nn.CrossEntropyLoss()``, by ``train_epoch`` + ``test`` and by
   ``fit_best``, each bit-equal (parameters, Adam state, history, selection)
   to the same run with the port's ``Adam`` and ``ArrayLoader``, with
   steps/s of both; no kernel launched while training; then the
   torch-trained MIMIC model and the quick-start model through
   ``export_model`` -> ``load_model``, each serving 8 requests of 16 rows
   with NaN rows through K1 (launches = requests x the plan's, 2 at MIMIC
   width) against the plain chain;
15. the earlier designs' times from PERF.md on a line of their own, the
   ``mnar``, ``transformer``, ``resume``, ``orders`` and ``dropin`` lines,
   one ``{"kernels": [...]}`` line of this run's numbers (launches summed
   over every path that ran the kernel, by phase in ``launches_by_phase``;
   K1's with ``titanic``, ``mnar``, ``resumed``, ``orders`` and ``dropin``
   blocks, K2's with ``resume`` and ``orders`` blocks), the script's wall
   time, the card's line, and last the ``{"ok": true, ...}`` line.

``--mnar-only`` runs phase 1 and the MNAR protocol grid alone at the
published cohort scale (300 patients, 5 folds) for ``batch``, ``sample``
and ``sample`` + lambda 25, ``--epochs`` deep.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""
import argparse
import contextlib
import csv
import glob
import importlib
import json
import os
import pickle
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from multimodn_tpu_torch import Adam, Adam8bit, InferenceSession, \
    MultiModN, MultiModNHistory, export_model, load_model
from multimodn_tpu_torch.core.fusion import default_order, forward_chain
from multimodn_tpu_torch.core.tree import tree_leaves
from multimodn_tpu_torch.data import ArrayLoader, PartitionDataset, Subset
from multimodn_tpu_torch.decoders import ClassDecoder, LogisticDecoder, \
    MLPDecoder
from multimodn_tpu_torch.encoders import MIMICMLPEncoder, MLPEncoder, \
    MLPFeatureEncoder
from multimodn_tpu_torch.ops import fused_adam as fa
from multimodn_tpu_torch.ops.build import library_path
from multimodn_tpu_torch.ops.fused_adam import FUSED_ADAM
from multimodn_tpu_torch.ops.fused_chain import FUSED_CHAIN, ChainSpec, \
    fused_chain_forward, fused_chain_forward_ref

START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
# MIMIC multi-task model at the defaults of pipelines/mimic/common.py.
MIMIC_STATE, MIMIC_WIDTHS, MIMIC_HIDDEN, MIMIC_TARGETS = 50, (10, 1024, 768,
                                                              99), 32, 2
KERNEL_BATCHES = (1, 16, 33, 1000, 65536)
SERVING_REQUESTS, SERVING_BATCH = 8, 16
# The kernel sums each dot product with fp32 FMAs in k order; cuBLAS's fp32
# GEMM sums in another order. Over K <= 1074 that moves each sum by ~1e-6,
# carried through up to 4 chained encoders and 3 decoder layers: 1e-4 leaves
# ~100x headroom and still catches any indexing or masking fault (those give
# O(0.1) errors).
TOL = 1e-4
TOL_REASON = ("fp32 FMA in k order vs cuBLAS fp32 GEMM order, K <= 1074, "
              "through <= 4 chained encoders + 3 decoder layers")
# H100 SXM data-sheet peaks: fp32 on the CUDA cores (the kernel's math is
# FFMA) and HBM3 bandwidth.
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
# The earlier designs' times (ms; one single-kernel chain, one launch per
# Adam leaf) from this script's final run before the redesign, as PERF.md
# section 6 keeps them; printed for comparison, not measured in this run.
EARLIER = {"source": "PERF.md section 6, this script before the redesign, "
                     "NVIDIA H100 80GB HBM3, 700.00 W; not measured in "
                     "this run",
           "fused_chain_ms": {"16": 0.2749, "65536": 2.1118},
           "fused_adam_ms": {"mimic_step": 0.1378, "mimic_step_int8": 0.1380,
                             "4096x1024": 0.0625, "65536": 0.1411,
                             "0-D": 0.0033}}

# The fused Adam kernel: the MIMIC protocol's optimizer settings, the extra
# leaf shapes (one past the 50 MB L2, a wide 1-D leaf, a 0-D leaf), and the
# tolerance. The kernel rounds every operation on its own in the plain
# version's order, so parameters, codes and scales must be bit-equal.
ADAM_LR, ADAM_BETAS, ADAM_EPS = 1e-3, (0.9, 0.999), 1e-8
ADAM_EXTRA_SHAPES = ((4096, 1024), (65536,), ())
ADAM_TOL = 0.0
ADAM_TOL_REASON = ("bit-equal: each float32 operation rounded on its own in "
                   "the plain version's order (no FMA contraction), IEEE "
                   "division and square root, round-to-nearest-even casts")
# Float32 operations per element of the update (dequantize 2, moments 7,
# step 7, requantize 6); the bytes bound it by far.
ADAM_OPS_PER_ELEMENT = 22
# Training: MIMIC-width synthetic data, the MIMIC protocol's batch.
TRAIN_SAMPLES, VAL_SAMPLES, TRAIN_EPOCHS, TRAIN_BATCH = 2048, 512, 3, 16
MISSING_RATE = 0.3
# Card against CPU, 3 Adam8bit steps from the same weights: cuBLAS and the
# CPU sum each product in another order (~1e-7 relative). Adam divides by
# the root of the second moment, so a near-zero gradient whose sign the two
# orders round differently moves its parameter by up to ~lr per step in
# opposite directions; over 3 steps that bounds a difference by ~6 lr.
DEVICE_TOL = 6 * ADAM_LR


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def mimic_model(device, seed=0, dropout=0.2, **kw):
    encoders = [MIMICMLPEncoder(MIMIC_STATE, w, (MIMIC_HIDDEN,) * 2,
                                dropout=dropout) for w in MIMIC_WIDTHS]
    decoders = [MLPDecoder(MIMIC_STATE, (MIMIC_HIDDEN,) * 2, 2)
                for _ in range(MIMIC_TARGETS)]
    return MultiModN(MIMIC_STATE, encoders, decoders, 1.0, 0.0, seed=seed,
                     device=device, **kw)


def small_model(device):
    S = 24
    encoders = [MLPEncoder(S, 40, (64,), "gelu"),
                MLPEncoder(S, 7, (16, 16), "tanh"),
                MLPEncoder(S, 13, ())]
    decoders = [ClassDecoder(S, 5, "softmax"),
                MLPDecoder(S, (16,), 3, "softmax", "gelu"),
                LogisticDecoder(S)]
    return MultiModN(S, encoders, decoders, 1.0, 0.0, seed=1, device=device)


TIMED_REPS, TIMED_GROUPS = 20, 5
TIMED_CALLS = 1 + TIMED_REPS * TIMED_GROUPS


def time_counted(fn, kernel):
    """``time_ms(fn)`` and the launches per call that ``kernel``'s counter
    saw during the timed calls."""
    before = kernel.launches
    ms = time_ms(fn)
    return ms, (kernel.launches - before) / TIMED_CALLS


def time_ms(fn, reps=TIMED_REPS, groups=TIMED_GROUPS) -> float:
    """Median over groups of the mean device time of one call (CUDA
    events). A sleep kernel first lets the host queue the group's launches
    ahead of the device, so small calls time the device, not the enqueue."""
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(groups):
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return statistics.median(means)


def macs_per_sample(spec: ChainSpec) -> int:
    """Multiply-adds one sample needs: every encoder layer once, every
    decoder layer on each of the E+1 state rows."""
    n_enc_layers = sum(p[2] for p in spec.enc_plans)
    macs = [(k + (spec.state_size if has_state else 0)) * n
            for _src, k, n, _act, has_state in spec.layers]
    rows = len(spec.encoders) + 1
    return sum(macs[:n_enc_layers]) + rows * sum(macs[n_enc_layers:])


def bound(spec: ChainSpec, B: int):
    """(bound_ms, bound_by, flops, bytes): each input read once, each
    output written once, fp32 FMA work at the fp32 peak."""
    E, S = len(spec.encoders), spec.state_size
    n_in = B * sum(e.n_features for e in spec.encoders) + B * E + S \
        + spec.n_weights
    n_out = (E + 1) * B * (S + sum(d.n_classes for d in spec.decoders))
    nbytes = 4 * (n_in + n_out)
    flops = 2 * macs_per_sample(spec) * B
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes)


def max_err(a, b) -> float:
    """Max abs difference over states and every decoder output; a NaN on
    either side counts as an infinite error."""
    pairs = [(a[0], b[0]), *zip(a[1], b[1])]
    return max(torch.nan_to_num((x - y).abs(), nan=float("inf")).max().item()
               for x, y in pairs)


def kernel_inputs(spec: ChainSpec, B: int, gen):
    device = gen.device
    data = tuple(torch.randn((B, e.n_features), generator=gen, device=device)
                 for e in spec.encoders)
    valid = (torch.rand((B, len(spec.encoders)), generator=gen,
                        device=device) >= 0.3).float()
    return data, valid


def stage_times(fn, calls=20):
    """Device time per call of each of K1's kernels (``torch.profiler``
    over ``calls`` calls), or None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for kernel in ("stage_a_gemm", "chain_kernel", "row_softmax"):
            if kernel in e.key and e.self_device_time_total > 0:
                out[kernel] = out.get(kernel, 0.0) + \
                    e.self_device_time_total / 1e3 / calls
    return out or None


def check_kernel(name, model, batches, gen):
    """Kernel against plain at each B; returns per-B records."""
    spec = ChainSpec(model.encoders, model.decoders, model.state_size)
    params = model.params
    layers = spec.layer_params(params)
    init_row = model.params["init_state"]["value"][0].contiguous()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    records = {}
    for B in batches:
        data, valid = kernel_inputs(spec, B, gen)
        got = fused_chain_forward(spec, params, data, valid, init_row)
        want = fused_chain_forward_ref(spec, params, data, valid, init_row)
        torch.cuda.synchronize()
        err = max_err(got, want)
        finite = all(torch.isfinite(t).all().item()
                     for t in [got[0], *got[1]])

        def kernel(large_tiles=True):
            FUSED_CHAIN.launch(spec, layers, data, valid, init_row,
                               large_tiles=large_tiles)

        ms, launches = time_counted(kernel, FUSED_CHAIN)
        plain_ms = time_ms(lambda: fused_chain_forward_ref(
            spec, params, data, valid, init_row))
        bound_ms, bound_by, flops, nbytes = bound(spec, B)
        # Each Stage A launch's GEMM blocks and the copy blocks of the
        # state-path weights, as the wrapper launches them.
        stage_a_blocks = [blocks for _i, _r, blocks in
                          spec.stage_a_plan(B, n_sm)[0]]
        copy_blocks = [blocks for _c, _r, blocks in spec.copy_groups]
        stages = stage_times(kernel) if B in (SERVING_BATCH, 65536) \
            else None
        records[B] = {"max_abs_err": err, "ms": ms, "launches": launches,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "flops": flops, "bytes": nbytes,
                      "stage_ms": stages}
        if B == 65536:
            records[B]["small_tiles_ms"] = time_ms(
                lambda: kernel(large_tiles=False))
        log(f"  {name} B={B}: max_abs_err={err:.3e} (tol {TOL:g}) "
            f"kernel {ms:.4f} ms in {launches:g} launches, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}; "
            f"{flops:.4g} FLOP, {nbytes:.4g} B), {bound_ms / ms:.2%} of "
            f"bound; Stage A GEMM blocks per launch {stage_a_blocks}, copy "
            f"blocks {copy_blocks}"
            + (f"; device ms per kernel {json.dumps(stages)}"
               if stages is not None else "")
            + (f"; Stage B on 16-row tiles: kernel "
               f"{records[B]['small_tiles_ms']:.4f} ms" if B == 65536
               else ""))
        if not finite or not err <= TOL:
            raise AssertionError(
                f"{name} B={B}: kernel disagrees with the plain version "
                f"(max abs err {err}, finite={finite})")
        if B == SERVING_BATCH and name == "mimic" and \
                not stage_a_blocks[0] > 1:
            raise AssertionError("Stage A runs on one block at B=16")
        if launches != spec.launches:
            raise AssertionError(f"{name} B={B}: {launches} launches per "
                                 f"call, the plan gives {spec.launches}")
        del data, valid, got, want
    return records


def serving_requests(seed=0, widths=MIMIC_WIDTHS):
    """8 requests of batch 16 over modalities of ``widths``; some rows have
    a NaN modality (whole row or a single entry) so the per-sample skip is
    exercised."""
    rng = np.random.default_rng(seed)
    requests = []
    for r in range(SERVING_REQUESTS):
        x = [rng.normal(size=(SERVING_BATCH, w)).astype(np.float32)
             for w in widths]
        if r % 2 == 0:
            for e in range(len(x)):
                rows = rng.choice(SERVING_BATCH, size=3, replace=False)
                x[e][rows[:2]] = np.nan
                x[e][rows[2], rng.integers(x[e].shape[1])] = np.nan
        requests.append(x)
    return requests


def served_errors(model, requests, answers, device):
    """Max abs errors of ``fused_forward``'s answers against the plain
    chain with the per-sample NaN skip, and of ``InferenceSession`` stepping
    through each request against the answers' state rows; fails on a
    non-finite answer."""
    n_enc = len(model.encoders)
    session = InferenceSession(model)
    err_chain = err_session = 0.0
    for x, (states, outs) in zip(requests, answers):
        if not all(torch.isfinite(t).all().item() for t in [states, *outs]):
            raise AssertionError("fused_forward gave non-finite values")
        B = x[0].shape[0]
        data = tuple(torch.as_tensor(m, device=device) for m in x)
        ref_states = forward_chain(
            model.encoders, model.init_state, model.params, data,
            torch.ones(B, device=device), order=default_order(n_enc),
            nan_skip="sample")[0]
        ref_outs = [dec.apply(model.params["decoders"][d], ref_states)
                    for d, dec in enumerate(model.decoders)]
        err_chain = max(err_chain, max_err((states, outs),
                                           (ref_states, ref_outs)))
        state = session.init(B)
        for e in range(n_enc):
            state, probs = session.step(state, e, x[e])
            err_session = max(err_session, max_err(
                (state, [torch.as_tensor(p, device=device) for p in probs]),
                (states[e + 1], [o[e + 1] for o in outs])))
    return err_chain, err_session


def serve(device):
    model_dir = os.path.join(ROOT, "build", "chip_smoke_model")
    source = mimic_model(device, seed=0)
    export_model(source, model_dir)
    model = load_model(model_dir, device=device)
    for a, b in zip(source.state_dict()["encoders"][1]["layers"],
                    model.state_dict()["encoders"][1]["layers"]):
        if not (np.array_equal(a["w"], b["w"])
                and np.array_equal(a["b"], b["b"])):
            raise AssertionError("load_model did not restore the weights")
    requests = serving_requests()

    # The main path: 8 requests through fused_forward, launches counted.
    torch.cuda.synchronize()
    FUSED_CHAIN.launches = 0
    answers, latencies = [], []
    for x in requests:
        t0 = time.perf_counter()
        states, outs = model.fused_forward(x)
        torch.cuda.synchronize()
        latencies.append(1e3 * (time.perf_counter() - t0))
        answers.append((states, outs))
    launches = FUSED_CHAIN.launches
    per_request = ChainSpec(model.encoders, model.decoders,
                            model.state_size).launches
    log(f"  {len(requests)} requests: K1 launches {launches} "
        f"({per_request} per request: Stage A, Stage B); request "
        f"latency (host clock, first call included) ms: "
        + ", ".join(f"{t:.3f}" for t in latencies))
    if launches != per_request * len(requests):
        raise AssertionError(f"K1 launched {launches} times for "
                             f"{len(requests)} fused_forward calls of "
                             f"{per_request} launches")

    n_enc = len(model.encoders)
    for states, _outs in answers:
        if states.shape != (n_enc + 1, SERVING_BATCH, MIMIC_STATE):
            raise AssertionError(f"states shape {tuple(states.shape)}")
    err_chain, err_session = served_errors(model, requests, answers, device)
    log(f"  fused_forward vs plain chain (nan_skip='sample'): max abs err "
        f"{err_chain:.3e}; InferenceSession vs fused_forward: "
        f"{err_session:.3e} (tol {TOL:g})")
    if not (err_chain <= TOL and err_session <= TOL):
        raise AssertionError("serving answers disagree with the plain chain")

    preds = model.predict(requests[1])
    proba = model.predict_proba(requests[1])
    want = (n_enc + 1, len(model.decoders), SERVING_BATCH)
    if preds.shape != want or any(
            p.shape != (n_enc + 1, SERVING_BATCH, 2) for p in proba):
        raise AssertionError(f"predict shapes {preds.shape}, "
                             f"{[p.shape for p in proba]}")
    if not all(np.isfinite(p).all() for p in proba):
        raise AssertionError("predict_proba on NaN-free data is not finite")
    log(f"  predict {preds.shape}, predict_proba "
        f"{[p.shape for p in proba]}")

    # Warm request latency: host clock from numpy request to answer on the
    # device, synchronised; 4 passes over the 8 requests.
    warm = []
    for _ in range(4):
        for x in requests:
            t0 = time.perf_counter()
            model.fused_forward(x)
            torch.cuda.synchronize()
            warm.append(1e3 * (time.perf_counter() - t0))
    serving = {"requests": len(warm), "batch": SERVING_BATCH,
               "request_ms_p50": float(np.percentile(warm, 50)),
               "request_ms_p90": float(np.percentile(warm, 90))}
    log(f"  warm fused_forward request latency: {json.dumps(serving)}")
    return launches, serving


def adam_grad(shape, gen, device):
    """A gradient whose rows mix magnitudes 1e-4 apart, with a zero row
    where the leaf has several rows."""
    g = torch.randn(shape, generator=gen, device=device)
    if len(shape) >= 1:
        g[..., ::2] *= 1e-4
    if len(shape) >= 2:
        g[0] = 0.0
    return g


def adam_leaf(shape, fmt, gen, device, prior_steps=3):
    """``[p, g, mq, ms, vq, vs, c12]`` of one leaf after ``prior_steps``
    plain updates from zero moments, with a fresh gradient and the next
    step's bias corrections."""
    b1, b2 = ADAM_BETAS
    qdt = fa.code_dtype(fmt)
    p = torch.randn(shape, generator=gen, device=device)
    mq, vq = (torch.zeros(shape, dtype=qdt, device=device) for _ in "mv")
    ms, vs = (torch.zeros(fa.scale_shape(shape), device=device)
              for _ in "mv")
    for t in range(1, prior_steps + 1):
        p, mq, ms, vq, vs = fa.leaf_update_ref(
            p, adam_grad(shape, gen, device), mq, ms, vq, vs,
            1 - b1 ** t, 1 - b2 ** t, ADAM_LR, b1, b2, ADAM_EPS, fmt=fmt)
    t = prior_steps + 1
    c12 = torch.tensor([1 - b1 ** t, 1 - b2 ** t], device=device)
    return [p, adam_grad(shape, gen, device), mq, ms, vq, vs, c12]


def adam_bound(shapes):
    """(bound_ms, bound_by, bytes): p, g, mq, vq read and p, mq, vq written
    (16 B per parameter), ms and vs read and written (16 B per row), c12
    read once per leaf."""
    n = sum(int(np.prod(s)) for s in shapes)
    rows = sum(fa.rows_cols(s)[0] for s in shapes)
    nbytes = 16 * n + 16 * rows + 8 * len(shapes)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ADAM_OPS_PER_ELEMENT * n / PEAK_FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def _bits(t):
    return t.view(torch.uint8) if t.element_size() == 1 else \
        t.view(torch.int32)


def check_adam_leaves(leaves, fmt):
    """``leaves`` (``[p, g, mq, ms, vq, vs, c12, gate]`` each) through one
    ``multi_leaf_update`` and through the plain version on the same
    inputs: returns (mismatching elements over p, codes and scales, max abs
    error of p, kernel launches). Two NaNs count as equal."""
    b1, b2 = ADAM_BETAS
    want = fa.multi_leaf_update_ref(leaves, lr=ADAM_LR, b1=b1, b2=b2,
                                    eps=ADAM_EPS, fmt=fmt)
    got = [[leaf[0].clone(), leaf[1]] + [t.clone() for t in leaf[2:6]]
           + list(leaf[6:]) for leaf in leaves]
    before = FUSED_ADAM.launches
    fa.multi_leaf_update(got, lr=ADAM_LR, b1=b1, b2=b2, eps=ADAM_EPS,
                         fmt=fmt)
    torch.cuda.synchronize()
    launches = FUSED_ADAM.launches - before
    # Summed on the card and read once: thousands of leaves, no sync each.
    bad, errs = [], []
    for leaf, w in zip(got, want):
        for a, b in zip([leaf[0]] + leaf[2:6], w):
            differ = _bits(a) != _bits(b)
            if a.element_size() != 1:
                differ &= ~(a.isnan() & b.isnan())
            bad.append(differ.sum())
        if leaf[0].numel():
            errs.append(torch.nan_to_num((leaf[0] - w[0]).abs(),
                                         nan=float("inf")).max())
    mismatches = int(torch.stack(bad).sum()) if bad else 0
    err = float(torch.stack(errs).max()) if errs else 0.0
    return mismatches, err, launches


def time_adam(shapes, fmt, gen, device):
    """Kernel and plain times of one update of every leaf in ``shapes``
    (one ``multi_leaf_update``), CUDA events, with the launches per update
    counted; and the kernel's times with one run of 4 elements per lane
    everywhere and with up to four runs wherever a row fits a block (the
    wrapper picks per leaf by the card's SM count)."""
    b1, b2 = ADAM_BETAS
    leaves = [tuple(adam_leaf(s, fmt, gen, device, prior_steps=1)) + (None,)
              for s in shapes]
    shapes = tuple(tuple(s) for s in shapes)

    def kernel(busy_blocks=None):
        FUSED_ADAM.launch(leaves, shapes, lr=ADAM_LR, b1=b1, b2=b2,
                          eps=ADAM_EPS, fmt=fmt, busy_blocks=busy_blocks)

    def plain():
        fa.multi_leaf_update_ref(leaves, lr=ADAM_LR, b1=b1, b2=b2,
                                 eps=ADAM_EPS, fmt=fmt)

    bound_ms, bound_by, nbytes = adam_bound(shapes)
    ms, launches = time_counted(kernel, FUSED_ADAM)
    if launches != fa.launches_per_update(shapes):
        raise AssertionError(f"fused_adam: {launches} launches per update "
                             f"of {len(shapes)} leaves")
    return {"ms": ms, "launches": launches, "plain_ms": time_ms(plain),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            # More busy blocks than any leaf fills: one run per lane; none:
            # up to four runs.
            "one_run_per_lane_ms": time_ms(lambda: kernel(2 ** 30)),
            "four_runs_per_lane_ms": time_ms(lambda: kernel(0))}


def check_adam(device, gen):
    """Phase 5: every case bit-equal through the multi-leaf path (all leaf
    shapes of one format and gate in one call), a call mixing groups with
    their own bias corrections and gates, and a NaN in a split row; then
    times at the MIMIC leaves (one optimizer step) and each extra shape."""
    b1, b2 = ADAM_BETAS
    shapes = [tuple(t.shape) for t in tree_leaves(mimic_model(device).params)]
    cases = sorted(set(shapes)) + list(ADAM_EXTRA_SHAPES)
    worst_err, total_bad = 0.0, 0

    def report(what, bad, err, launches):
        nonlocal worst_err, total_bad
        worst_err, total_bad = max(worst_err, err), total_bad + bad
        log(f"  {what}: {bad} mismatching elements, max abs err of p "
            f"{err:.3e}, {launches} launches")
        if bad > 0:
            raise AssertionError(
                f"fused_adam disagrees with the plain version ({what}): "
                f"{bad} elements of p, codes or scales differ")

    for fmt in ("fp8", "int8"):
        for gate in (None, 0.0, 1.0):
            g = None if gate is None else torch.tensor(gate, device=device)
            leaves = [adam_leaf(s, fmt, gen, device) + [g] for s in cases]
            report(f"fmt={fmt} gate={gate}, {len(cases)} leaf shapes",
                   *check_adam_leaves(leaves, fmt))
        # Three groups in one call, each with its own step count and gate,
        # as an optimizer step with per-encoder groups makes them.
        gates = [None, torch.tensor(1.0, device=device),
                 torch.tensor(0.0, device=device)]
        leaves = []
        for i, s in enumerate(shapes + [(4096, 1024), (65536,)]):
            leaf = adam_leaf(s, fmt, gen, device, prior_steps=1 + i % 3)
            leaves.append(leaf + [gates[i % 3]])
        report(f"fmt={fmt} mixed groups, {len(leaves)} leaves",
               *check_adam_leaves(leaves, fmt))
        # A NaN in a row split across blocks poisons that row only.
        leaf = adam_leaf((2, 65536), fmt, gen, device) + [None]
        leaf[1][1, 40000] = float("nan")
        bad, err, launches = check_adam_leaves([leaf], fmt)
        report(f"fmt={fmt} NaN in a split (2, 65536) row", bad, 0.0,
               launches)

    times = {"mimic_step": time_adam(shapes, "fp8", gen, device)}
    for s in ADAM_EXTRA_SHAPES:
        times["x".join(map(str, s)) or "0-D"] = time_adam([s], "fp8", gen,
                                                         device)
    times["mimic_step_int8"] = time_adam(shapes, "int8", gen, device)
    for name, r in times.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms in {r['launches']:g} "
            f"launches, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}; {r['bytes']:.4g} B), "
            f"{r['bound_ms'] / r['ms']:.2%} of bound; lanes: one run each "
            f"{r['one_run_per_lane_ms']:.4f} ms, up to four runs "
            f"{r['four_runs_per_lane_ms']:.4f} ms")
    return {"max_abs_err": worst_err, "mismatches": total_bad,
            "n_leaves": len(shapes),
            "launches_per_step": fa.launches_per_update(shapes),
            "times": times}


def mimic_training_loaders(seed=0):
    """2048 train and 512 val samples at the MIMIC widths; 30% of (sample,
    modality) cells missing; two labels from a fixed random linear rule on
    the first 8 features of every modality."""
    rng = np.random.default_rng(seed)
    n, width = TRAIN_SAMPLES + VAL_SAMPLES, sum(MIMIC_WIDTHS)
    X = rng.normal(size=(n, width)).astype(np.float32)
    offsets = np.cumsum((0,) + MIMIC_WIDTHS[:-1])
    w = np.zeros((width, MIMIC_TARGETS), np.float32)
    for off in offsets:
        w[off:off + 8] = rng.normal(size=(8, MIMIC_TARGETS))
    y = (X @ w > 0).astype(np.int64)
    missing = rng.random((n, len(MIMIC_WIDTHS))) < MISSING_RATE
    for e, (off, wd) in enumerate(zip(offsets, MIMIC_WIDTHS)):
        X[missing[:, e], off:off + wd] = np.nan
    ds = PartitionDataset(X, y, list(MIMIC_WIDTHS))
    train, val, _ = ds.random_split((TRAIN_SAMPLES, VAL_SAMPLES, 0), seed=0)
    return ds, train, val


def train(device, make_optimizer, train_set, val_set):
    """``fit_best`` for 3 epochs, a timed extra ``train_epoch``, ``test``.
    The fused Adam kernel's launches are counted over ``fit_best`` alone
    (the main path)."""
    model = mimic_model(device)
    optimizer = make_optimizer()
    train_loader = ArrayLoader(train_set, TRAIN_BATCH, shuffle=True, seed=0)
    val_loader = ArrayLoader(val_set, TRAIN_BATCH)
    history = MultiModNHistory([f"t{d}" for d in range(MIMIC_TARGETS)])
    torch.cuda.synchronize()
    FUSED_ADAM.launches = 0
    t0 = time.perf_counter()
    best = model.fit_best(train_loader, optimizer, "cross_entropy",
                          epochs=TRAIN_EPOCHS, val_loader=val_loader,
                          history=history)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = FUSED_ADAM.launches
    t0 = time.perf_counter()
    model.train_epoch(train_loader, optimizer, "cross_entropy")
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    results = model.test(val_loader, "cross_entropy")
    losses = [float(np.mean(g)) for g in history.loss["train"]]
    steps = best["epochs_ran"] * train_loader.n_batches
    return {"launches": launches, "steps": steps, "losses": losses,
            "val_losses": [float(np.mean(g)) for g in history.loss["val"]],
            "best_epoch": best["best_epoch"],
            "best_score": best["best_score"],
            "scores": [float(x) for x in best["scores"]],
            "fit_best_s": fit_s, "fit_best_ms_per_epoch":
                1e3 * fit_s / best["epochs_ran"],
            "train_epoch_ms": 1e3 * epoch_s,
            "train_step_ms": 1e3 * epoch_s / train_loader.n_batches,
            "test": [{"f1": r[0], "auc": r[1], "accuracy": r[2]}
                     for r in results]}


def check_training(device):
    """Phase 6: the main training path and its checks."""
    _ds, train_set, val_set = mimic_training_loaders()
    runs = {}
    for name, make in (("Adam8bit", lambda: Adam8bit(ADAM_LR)),
                       ("Adam", lambda: Adam(ADAM_LR))):
        r = train(device, make, train_set, val_set)
        runs[name] = r
        log(f"  {name}: {json.dumps(r)}")
        if not all(np.isfinite(r["losses"] + r["val_losses"]
                               + r["scores"])):
            raise AssertionError(f"{name}: a loss or score is not finite")
        if not r["losses"][-1] < r["losses"][0]:
            raise AssertionError(f"{name}: the training loss did not fall "
                                 f"({r['losses']})")
        if not all(np.isfinite(t["auc"]) for t in r["test"]):
            raise AssertionError(f"{name}: test gave a non-finite AUROC")
    r = runs["Adam8bit"]
    shapes = [tuple(t.shape) for t in tree_leaves(mimic_model(device).params)]
    per_step = fa.launches_per_update(shapes)
    if r["launches"] != per_step * r["steps"]:
        raise AssertionError(
            f"fused_adam launched {r['launches']} times for {r['steps']} "
            f"steps of {per_step} launches ({len(shapes)} leaves)")
    log(f"  fused_adam launches {r['launches']} = {per_step} per step "
        f"({len(shapes)} leaves) x {r['steps']} steps; best epoch "
        f"{r['best_epoch']}, score {r['best_score']:.4f}")
    for name, run in runs.items():
        log(f"  {name}: {run['train_step_ms']:.3f} ms per training step, "
            f"{run['train_epoch_ms']:.1f} ms per training epoch "
            f"({TRAIN_SAMPLES // TRAIN_BATCH} steps), "
            f"{run['fit_best_ms_per_epoch']:.1f} ms per fit_best epoch "
            f"(train + val + selection)")
    return runs


def profile_steps(model, loader, optimizer, label, kernel=None,
                  warm_up=True, key_averages=False):
    """Where a training step's time goes: ``torch.profiler`` over one
    ``train_epoch`` of ``loader``, after a warm-up epoch unless the model is
    warm already. The device time is the sum of the kernels' own times;
    the wall time is the host clock around the epoch, synchronised, with
    the profiler's own cost in it. ``kernel``: a name fragment whose
    kernels' device ms and launches per step are reported on their own.
    ``key_averages``: also read the same trace through ``key_averages()``,
    the profiler's own per-name table, under ``"key_averages"``, so that
    readings taken that way compare with this one."""
    from torch.profiler import ProfilerActivity, profile
    if warm_up:
        model.train_epoch(loader, optimizer, "cross_entropy")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.train_epoch(loader, optimizer, "cross_entropy")
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    steps = loader.n_batches
    # The device events straight from the profiler's results: key_averages()
    # would first build every host event, minutes of host time for the
    # ~10^5 kernels of a featurewise step.
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    device_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    r = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
         "device_ms_per_step": device_ms / steps if device_ms else None,
         "device_busy_share": device_ms / wall_ms if device_ms else None,
         "kernels_per_step": sum(n for _, n in by_name.values()) / steps,
         "top_kernels": [{"name": name[:80], "ms_per_step": ms / steps,
                          "per_step": n / steps}
                         for name, (ms, n) in top]}
    if kernel is not None:
        own = [v for name, v in by_name.items() if kernel in name]
        r[kernel] = {"ms_per_step": sum(ms for ms, _ in own) / steps,
                     "per_step": sum(n for _, n in own) / steps}
    if key_averages:
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        avg_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        r["key_averages"] = {
            "device_ms_per_step": avg_ms / steps,
            "device_busy_share": avg_ms / wall_ms,
            "kernels_per_step": sum(e.count for e in kernels) / steps}
    log(f"  profile of {steps} {label} steps: {json.dumps(r)}"
        + ("" if device_ms else " (the profiler saw no device time: not "
           "measured)"))
    return r


def profile_training(device, steps=8):
    """Phase 6's profile: ``steps`` Adam8bit steps of the MIMIC model."""
    _ds, train_set, _ = mimic_training_loaders()
    loader = ArrayLoader(Subset(train_set.dataset,
                                train_set.indices[:steps * TRAIN_BATCH]),
                         TRAIN_BATCH)
    return profile_steps(mimic_model(device), loader, Adam8bit(ADAM_LR),
                         "Adam8bit", key_averages=True)


def check_device_vs_cpu(device):
    """Phase 7: 3 Adam8bit steps from the same weights on the card and on
    the CPU, dropout off, the same batches."""
    ds, train_set, _ = mimic_training_loaders()
    subset = Subset(ds, train_set.indices[:3 * TRAIN_BATCH])
    gpu = mimic_model(device, seed=1, dropout=0.0)
    cpu = mimic_model("cpu", seed=1, dropout=0.0)
    cpu.load_state_dict(gpu.state_dict())
    for model in (gpu, cpu):
        model.train_epoch(ArrayLoader(subset, TRAIN_BATCH),
                          Adam8bit(ADAM_LR), "cross_entropy")
    diffs = np.concatenate([
        np.abs(a - b).reshape(-1) for a, b in zip(
            tree_leaves(gpu.state_dict()), tree_leaves(cpu.state_dict()))])
    err = float(np.nan_to_num(diffs, nan=np.inf).max())
    log(f"  card vs CPU after 3 Adam8bit steps: max abs param diff "
        f"{err:.3e} (tol {DEVICE_TOL:g}), {int((diffs > 1e-6).sum())} of "
        f"{diffs.size} parameters differ by more than 1e-6")
    if not err <= DEVICE_TOL:
        raise AssertionError("the card and the CPU disagree after 3 steps")
    return err


# Phase 8: the three MIMIC pipelines with their argv and the rows their
# results CSVs must hold (2 targets x 5 folds x (MultiModN, HAIM); 5 folds x
# 2 targets x 2 models; and twice that for MNAR's clean and flipped tests).
PROTOCOL_EPOCHS = 3
PROTOCOL_RUNS = (
    ("mimic_single_task_pipeline", [], 20),
    ("mimic_multi_task_pipeline", [], 20),
    ("mimic_single_task_mnar_missingness_pipeline", ["-p", "50"], 40),
)
FOREIGN_MODULES = ("pandas", "sklearn", "jax", "multimodn_tpu")


def foreign_modules():
    return sorted(k for k, v in sys.modules.items()
                  if v is not None and k.split(".")[0] in FOREIGN_MODULES)


class PhaseClock:
    """Synchronised host time spent inside wrapped functions, per phase
    (nested calls of one phase count once), and training steps per phase."""

    def __init__(self):
        self.seconds, self.steps, self._depth = {}, {}, {}
        self._undo = []

    def wrap(self, owner, name, phase, steps=None):
        fn = getattr(owner, name)

        def timed(*args, **kwargs):
            depth = self._depth.get(phase, 0)
            self._depth[phase] = depth + 1
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            finally:
                self._depth[phase] = depth
            if depth == 0:
                self.seconds[phase] = self.seconds.get(phase, 0.0) + \
                    time.perf_counter() - t0
            if steps is not None:
                self.steps[phase] = self.steps.get(phase, 0) + \
                    steps(out, *args, **kwargs)
            return out

        setattr(owner, name, timed)
        self._undo.append((owner, name, fn))

    def restore(self):
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo = []

    def take(self):
        out = (self.seconds, self.steps)
        self.seconds, self.steps = {}, {}
        return out


def fold_clock():
    """A ``PhaseClock`` on the MultiModN and HAIM folds (training with
    steps counted, and testing)."""
    from multimodn_tpu_torch.baselines.haim import HAIM
    clock = PhaseClock()
    clock.wrap(MultiModN, "_fit_best", "modn", steps=lambda out, self, tr,
               *a, **k: out[0]["epochs_ran"] * tr.n_batches)
    clock.wrap(MultiModN, "test", "modn")
    clock.wrap(HAIM, "fit_best", "haim", steps=lambda out, self, tr, *a,
               **k: len(out["scores"]) * tr.n_batches)
    clock.wrap(HAIM, "test", "haim")
    return clock


def fold_rates(seconds, steps):
    """Seconds, training steps and steps/s of the MultiModN and HAIM
    folds."""
    out = {}
    for model in ("modn", "haim"):
        out[f"{model}_s"] = seconds.get(model, 0.0)
        out[f"{model}_steps"] = steps.get(model, 0)
        out[f"{model}_steps_per_s"] = steps.get(model, 0) / max(
            seconds.get(model, 0.0), 1e-9)
    return out


@contextlib.contextmanager
def scratch_storage(prefix):
    """A temporary directory for ``MULTIMODN_STORAGE`` and the MIMIC data
    cache (the real-CSV path unset); all restored and removed after."""
    from multimodn_tpu_torch.data import mimic as mimic_data
    work = tempfile.mkdtemp(prefix=prefix)
    saved_env = {k: os.environ.get(k) for k in
                 ("MULTIMODN_STORAGE", "MULTIMODN_MIMIC_EMBED_PATH")}
    saved_root = mimic_data.DEFAULT_CACHE_ROOT
    os.environ["MULTIMODN_STORAGE"] = os.path.join(work, "store")
    os.environ.pop("MULTIMODN_MIMIC_EMBED_PATH", None)
    mimic_data.DEFAULT_CACHE_ROOT = os.path.join(work, "cache")
    try:
        yield work
    finally:
        mimic_data.DEFAULT_CACHE_ROOT = saved_root
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(work, ignore_errors=True)


def run_protocol(device, patients=None, epochs=PROTOCOL_EPOCHS,
                 stream_folds=False):
    """Phase 8: the three MIMIC pipelines on the card, on the synthetic
    table of ``patients`` patients (default: the pipelines' own), their
    folds streamed with ``stream_folds``."""
    from multimodn_tpu_torch.baselines.haim import HAIM
    from multimodn_tpu_torch.data import mimic as mimic_data
    from multimodn_tpu_torch.data import table as table_io
    from multimodn_tpu_torch.pipelines.mimic import common

    if patients is None:
        patients = common.MimicConfig().synthetic_patients

    if foreign_modules():
        raise AssertionError(f"loaded before phase 8: {foreign_modules()}")
    models = []
    build = common.build_modn

    def recording_build(*args, **kwargs):
        models.append(build(*args, **kwargs))
        return models[-1]

    class RecordingHAIM(HAIM):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            models.append(self)

    clock = fold_clock()
    clock.wrap(mimic_data.MIMICDataset, "__init__", "data")
    clock.wrap(mimic_data, "build_mimic_cache", "data")
    common.build_modn, common.HAIM = recording_build, RecordingHAIM
    # Each parse of a cache file: its seconds, and whether the per-file
    # parse memo of data/table.py served it (the same array came back).
    parses, read_numeric = [], mimic_data.read_numeric_csv

    def timed_read(path):
        t0 = time.perf_counter()
        out = read_numeric(path)
        parses.append((time.perf_counter() - t0, id(out[1]),
                       out[1].shape[1]))
        return out

    mimic_data.read_numeric_csv = timed_read

    def undo_patches():
        clock.restore()
        common.build_modn, common.HAIM = build, HAIM
        mimic_data.read_numeric_csv = read_numeric

    results = {}
    with contextlib.ExitStack() as stack:
        stack.callback(undo_patches)
        work = stack.enter_context(scratch_storage("chip_smoke_protocol_"))
        for module, argv, want_rows in PROTOCOL_RUNS:
            main = importlib.import_module(
                f"multimodn_tpu_torch.pipelines.mimic.{module}").main
            # Each pipeline starts as in a process of its own: no parse is
            # kept from the one before (the cache files on disk are).
            table_io._NUMERIC_CACHE.clear()
            del parses[:]
            cfg = common.MimicConfig(synthetic_patients=patients,
                                     stream_folds=stream_folds)
            torch.cuda.synchronize()
            FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
            n_models = len(models)
            t0 = time.perf_counter()
            rows = main(argv + ["-e", str(epochs)], cfg, device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            seconds, steps = clock.take()
            launched = (FUSED_CHAIN.launches, FUSED_ADAM.launches)
            name = module.replace("_pipeline", "")
            path = os.path.join(work, "store", "nips", "results",
                                f"{name}_(auc + bac).csv")
            with open(path, newline="") as f:
                table = list(csv.DictReader(f))
            aucs = [float(r["auc"]) for r in table]
            if len(table) != want_rows or len(rows) != want_rows:
                raise AssertionError(f"{name}: {len(table)} CSV rows, "
                                     f"{len(rows)} results; want {want_rows}")
            if not all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in aucs):
                raise AssertionError(f"{name}: AUROC outside [0, 1]: {aucs}")
            off_card = [type(m).__name__ for m in models[n_models:]
                        if not all(t.is_cuda for t in tree_leaves(m.params))]
            if off_card or len(models) == n_models:
                raise AssertionError(f"{name}: parameters off the card in "
                                     f"{off_card}")
            if launched != (0, 0):
                raise AssertionError(f"{name}: the fused kernels launched "
                                     f"{launched} times on the protocol "
                                     f"path, which runs neither")
            first = {}
            for sec, key, _ in parses:
                first.setdefault(key, sec)
            miss_s = sum(first.values())
            other = wall - sum(seconds.values())
            r = {"patients": patients, "epochs": epochs,
                 "stream_folds": stream_folds,
                 "rows": len(table), "wall_s": wall,
                 "data_and_cache_s": seconds.get("data", 0.0),
                 "modn_folds_s": seconds.get("modn", 0.0),
                 "haim_folds_s": seconds.get("haim", 0.0),
                 "other_s": other,
                 "modn_steps": steps.get("modn", 0),
                 "haim_steps": steps.get("haim", 0),
                 "modn_steps_per_s": steps.get("modn", 0)
                 / max(seconds.get("modn", 0.0), 1e-9),
                 "haim_steps_per_s": steps.get("haim", 0)
                 / max(seconds.get("haim", 0.0), 1e-9),
                 "models": len(models) - n_models,
                 "auc_min": min(aucs), "auc_max": max(aucs),
                 "parses": len(parses), "parse_misses": len(first),
                 "parse_miss_s": miss_s,
                 "parse_hit_s": sum(p[0] for p in parses) - miss_s,
                 "cache_rows": max(p[2] for p in parses),
                 "k1_launches": launched[0], "k2_launches": launched[1]}
            results[name] = r
            log(f"  {name}: {json.dumps(r)}")
    if foreign_modules():
        raise AssertionError(f"loaded by phase 8: {foreign_modules()}")
    log(f"  pandas, scikit-learn, JAX and the JAX package not loaded; "
        f"MultiModN and HAIM parameters on {device}")
    return results


# Phase 9: the six Titanic pipelines at the reference's smoke depth
# (pipelines/test_all_pipelines.sh:13), the quick-start at its published
# depth, and the trained MLP-family models served through K1.
TITANIC_PIPELINES = ("titanic_mlp", "titanic_partitioned",
                     "titanic_featurewise", "titanic_missingness",
                     "titanic_lstm", "titanic_rnn")
TITANIC_EPOCHS, QUICKSTART_EPOCHS = 5, 300
# K1's Titanic shapes: the pipeline whose trained model each one serves.
TITANIC_SERVED = (("S=1, MLPEncoder(1, 6, (5, 5))", "titanic_mlp"),
                  ("S=5, partitions 3 + 2", "titanic_partitioned"),
                  ("S=5, 5 x 1-feature", "titanic_featurewise"),
                  ("S=5, 6 x 1-feature, NaN cells", "titanic_missingness"))


def titanic_pipeline(name):
    return importlib.import_module(
        f"multimodn_tpu_torch.pipelines.titanic.{name}_pipeline")


def mean_losses(history, tag):
    return [float(np.mean(g)) for g in history.loss[tag]]


def run_titanic_pipelines(device, work):
    """The six pipelines through ``common.run`` at 5 epochs, the results
    CSV on (in ``work``), plots and pickles off; returns (records, trained
    models)."""
    from multimodn_tpu_torch.pipelines.titanic import common
    records, trained = {}, {}
    for name in TITANIC_PIPELINES:
        cfg = titanic_pipeline(name).CONFIG
        t0 = time.perf_counter()
        model, history = common.run(
            cfg, os.path.join(work, f"{name}_pipeline.py"),
            ["-e", str(TITANIC_EPOCHS), "-m", "false", "-y", "false", "-p",
             "false", "-r", "true"], device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        train, _val, _ = common.split(cfg, 0)
        steps = TITANIC_EPOCHS * common.loader(cfg, train).n_batches
        with open(os.path.join(work, "results", f"{name}.csv"),
                  newline="") as f:
            rows = list(csv.reader(f))
        r = {"wall_s": wall, "steps": steps, "steps_per_s": steps / wall,
             "train_loss": mean_losses(history, "train"),
             "val_loss": mean_losses(history, "val"),
             "results_csv_rows": len(rows) - 1}
        log(f"  {name}: {json.dumps(r)}")
        if not np.isfinite(r["train_loss"] + r["val_loss"]).all():
            raise AssertionError(f"{name}: a loss is not finite")
        if not all(t.device.type == device.type
                   for t in tree_leaves(model.params)):
            raise AssertionError(f"{name}: parameters off {device}")
        if rows[0][0] != "Target" or len(rows) != 1 + len(cfg.targets):
            raise AssertionError(f"{name}: results CSV {rows[:2]}")
        records[name], trained[name] = r, model
    return records, trained


def run_quickstart(device):
    """The quick-start: the titanic_mlp config for 300 epochs of ``fit``
    with validation, then ``test`` on the validation set."""
    from multimodn_tpu_torch.pipelines.titanic import common
    cfg = titanic_pipeline("titanic_mlp").CONFIG
    train, val, _ = common.split(cfg, 0)
    model = common.build_model(cfg, 0, device)
    history = MultiModNHistory(cfg.targets)
    t0 = time.perf_counter()
    model.fit(common.loader(cfg, train), Adam(cfg.learning_rate),
              "cross_entropy", epochs=QUICKSTART_EPOCHS, history=history,
              val_loader=common.loader(cfg, val))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    f1, auc, acc = model.test(common.loader(cfg, val), "cross_entropy")[0][:3]
    losses = mean_losses(history, "train")
    steps = QUICKSTART_EPOCHS * common.loader(cfg, train).n_batches
    r = {"epochs": QUICKSTART_EPOCHS, "fit_s": fit_s, "steps": steps,
         "steps_per_s": steps / fit_s, "first_train_loss": losses[0],
         "last_train_loss": losses[-1],
         "last_val_loss": mean_losses(history, "val")[-1],
         "val_auroc": float(auc), "val_f1": float(f1),
         "val_accuracy": float(acc)}
    log(f"  quick-start: {json.dumps(r)}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"quick-start: the training loss did not fall "
                             f"({losses[0]} -> {losses[-1]})")
    if not np.isfinite(auc):
        raise AssertionError("quick-start: validation AUROC is not finite")
    return r, model


def serve_trained(name, model, requests, device):
    """A trained model's requests through ``fused_forward`` (K1), launches
    counted over them, held against the plain chain and
    ``InferenceSession``; then K1 alone at the first request's inputs,
    timed beside its plain version and its bound."""
    spec = ChainSpec(model.encoders, model.decoders, model.state_size)
    torch.cuda.synchronize()
    FUSED_CHAIN.launches = 0
    answers = [model.fused_forward(x) for x in requests]
    torch.cuda.synchronize()
    launches = FUSED_CHAIN.launches
    if launches != spec.launches * len(requests):
        raise AssertionError(
            f"{name}: K1 launched {launches} times for {len(requests)} "
            f"requests of {spec.launches} launches")
    nan_cells = int(sum(np.isnan(m).any(axis=1).sum()
                        for x in requests for m in x))
    err_chain, err_session = served_errors(model, requests, answers, device)
    if not (err_chain <= TOL and err_session <= TOL):
        raise AssertionError(f"{name}: served answers disagree with the "
                             f"plain chain ({err_chain}, {err_session})")
    data = model._to_device(requests[0])
    valid = torch.stack([~torch.isnan(m).any(dim=1) for m in data],
                        dim=1).float()
    data = tuple(torch.nan_to_num(m).contiguous() for m in data)
    init_row = model.params["init_state"]["value"][0].contiguous()
    layers = spec.layer_params(model.params)
    ms, per_call = time_counted(lambda: FUSED_CHAIN.launch(
        spec, layers, data, valid, init_row), FUSED_CHAIN)
    plain_ms = time_ms(lambda: fused_chain_forward_ref(
        spec, model.params, data, valid, init_row))
    bound_ms, bound_by, flops, nbytes = bound(spec, data[0].shape[0])
    if per_call != spec.launches:
        raise AssertionError(f"{name}: {per_call} launches per timed call, "
                             f"the plan gives {spec.launches}")
    return {"pipeline": name, "requests": len(requests),
            "rows": sum(x[0].shape[0] for x in requests),
            "nan_cells": nan_cells, "launches": launches,
            "launches_per_request": spec.launches, "max_abs_err": err_chain,
            "session_max_abs_err": err_session, "batch": data[0].shape[0],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "flops": flops, "bytes": nbytes}


def export_and_load(model, path, device, name):
    """``export_model`` -> ``load_model``, every weight bit-equal."""
    export_model(model, path)
    loaded = load_model(path, device=device)
    for a, b in zip(tree_leaves(model.state_dict()),
                    tree_leaves(loaded.state_dict())):
        if not np.array_equal(a, b):
            raise AssertionError(f"{name}: load_model changed a weight")
    return loaded


def request_batches(dataset, rows):
    """``rows`` of a partition dataset as requests of 16 rows."""
    xs, _y, _ = dataset.arrays()
    rows = np.asarray(rows)
    return [[m[rows[i:i + SERVING_BATCH]] for m in xs]
            for i in range(0, len(rows), SERVING_BATCH)]


def serve_titanic(device, trained, work):
    """Each trained MLP-family model through ``export_model`` ->
    ``load_model``, then its validation set in requests of 16 rows
    (``serve_trained``)."""
    from multimodn_tpu_torch.pipelines.titanic import common
    out = {}
    for label, name in TITANIC_SERVED:
        cfg = titanic_pipeline(name).CONFIG
        model = export_and_load(trained[name],
                                os.path.join(work, "export", name), device,
                                name)
        _train, val, _ = common.split(cfg, 0)
        r = serve_trained(name, model, request_batches(val.dataset,
                                                       val.indices), device)
        log(f"  K1 at {label}: {json.dumps(r)}")
        out[label] = r
    return out


def profile_titanic(device, steps=8):
    """``steps`` training steps of the quick-start and of the LSTM
    pipeline's model (``Adam``, batch 32) under ``torch.profiler``."""
    from multimodn_tpu_torch.pipelines.titanic import common
    out = {}
    for name in ("titanic_mlp", "titanic_lstm"):
        cfg = titanic_pipeline(name).CONFIG
        train, _val, _ = common.split(cfg, 0)
        loader = ArrayLoader(Subset(train.dataset, train.indices[
            :steps * cfg.batch_size]), cfg.batch_size)
        out[name] = profile_steps(common.build_model(cfg, 0, device), loader,
                                  Adam(cfg.learning_rate), f"{name} Adam")
    return out


def run_titanic(device):
    """Phase 9: the Titanic pipelines, the quick-start and its serving."""
    if foreign_modules():
        raise AssertionError(f"loaded before phase 9: {foreign_modules()}")
    work = tempfile.mkdtemp(prefix="chip_smoke_titanic_")
    try:
        torch.cuda.synchronize()
        FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
        pipelines, trained = run_titanic_pipelines(device, work)
        quick, trained["titanic_mlp"] = run_quickstart(device)
        torch.cuda.synchronize()
        if (FUSED_CHAIN.launches, FUSED_ADAM.launches) != (0, 0):
            raise AssertionError(
                f"training launched the fused kernels "
                f"{(FUSED_CHAIN.launches, FUSED_ADAM.launches)} times; it "
                f"runs the plain chain and Adam")
        profiles = profile_titanic(device)
        served = serve_titanic(device, trained, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if foreign_modules():
        raise AssertionError(f"loaded by phase 9: {foreign_modules()}")
    log(f"  pandas, scikit-learn, JAX and the JAX package not loaded; "
        f"every parameter on {device}")
    return {"pipelines": pipelines, "quickstart": quick, "served": served,
            "profile": profiles}


# Phase 10: the MNAR robustness protocol (the port of
# nips/run_mnar_protocol.py), cut, for the batch-granular skip and for the
# per-sample skip with the presence penalty; then a lambda-trained MIMIC
# model served through K1. --mnar-only runs the grid at the published
# cohort scale (300 patients, 5 folds) for the three published variants.
MNAR_PATIENTS, MNAR_FOLDS, MNAR_EPOCHS = 120, 2, 2
MNAR_VARIANTS = (("batch", 0.0), ("sample", 25.0))
MNAR_FULL_PATIENTS, MNAR_FULL_FOLDS = 300, 5
MNAR_FULL_VARIANTS = (("batch", 0.0), ("sample", 0.0), ("sample", 25.0))
MNAR_SERVED_MISS, MNAR_SERVED_LAMBDA = 80.0, 25.0


def flipped_table(summary, levels):
    """Mean test AUROC per model and level: the flipped-class degraded test
    above 0%, the clean test at 0% (the JAX script's table), and the clean
    test at every level."""
    out = {}
    for model in ("modn", "haim"):
        for kind, flipped in (("flipped", True), ("clean", False)):
            cells = []
            for mp in levels:
                sel = np.flatnonzero(
                    (summary["model"] == model)
                    & (summary["miss_perc"] == mp)
                    & (summary["both"] == (flipped and mp > 0)))
                cells.append(float(summary["mean"][sel[0]]) if len(sel)
                             else None)
            out[f"{model}_{kind}"] = cells
    return out


def run_mnar(device, patients, nfold, epochs, variants):
    """The MNAR protocol runner for each ``(nan_skip, lambda)`` variant in a
    temporary storage and cache directory: wall time per variant and per
    level, MultiModN and HAIM steps/s, the rows and summary checked."""
    from multimodn_tpu_torch.pipelines.mimic import mnar_protocol as proto

    if foreign_modules():
        raise AssertionError(f"loaded before phase 10: {foreign_modules()}")
    levels = proto.MISS_PERCS
    level_s = []
    pipeline_main = proto.mnar_pipeline.main

    def timed_level(*args, **kwargs):
        t0 = time.perf_counter()
        out = pipeline_main(*args, **kwargs)
        torch.cuda.synchronize()
        level_s.append(time.perf_counter() - t0)
        return out

    def undo_patches():
        proto.mnar_pipeline.main = pipeline_main
        clock.restore()

    clock = fold_clock()
    proto.mnar_pipeline.main = timed_level
    results = {}
    with contextlib.ExitStack() as stack:
        stack.callback(undo_patches)
        work = stack.enter_context(scratch_storage("chip_smoke_mnar_"))
        for nan_skip, lam in variants:
            del level_s[:]
            torch.cuda.synchronize()
            FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
            t0 = time.perf_counter()
            summary = proto.main(patients, epochs, nfold, nan_skip, lam,
                                 device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            seconds, steps = clock.take()
            tag = proto.variant_tag(nan_skip, lam, patients, epochs, nfold)
            path = os.path.join(work, "store", "nips", "results",
                                f"mnar_protocol_rows_{tag}.csv")
            with open(path, newline="") as f:
                table = list(csv.DictReader(f))
            want_rows = 2 * nfold * (1 + 2 * (len(levels) - 1))
            for model in ("modn", "haim"):
                n = sum(r["model"] == model for r in table)
                if n != want_rows:
                    raise AssertionError(f"{tag}: {n} {model} rows, want "
                                         f"{want_rows}")
            aucs = [float(r["test_auc"]) for r in table]
            if not all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in aucs):
                raise AssertionError(f"{tag}: AUROC outside [0, 1]")
            n_groups = 2 * (2 * len(levels) - 1)
            if len(summary["mean"]) != n_groups or list(
                    summary["count"]) != [2 * nfold] * n_groups:
                raise AssertionError(f"{tag}: summary {summary}")
            if (FUSED_CHAIN.launches, FUSED_ADAM.launches) != (0, 0):
                raise AssertionError(f"{tag}: the fused kernels launched on "
                                     f"the protocol path, which runs neither")
            r = {"patients": patients, "folds": nfold, "epochs": epochs,
                 "wall_s": wall,
                 "level_s": dict(zip([str(mp) for mp in levels], level_s)),
                 **fold_rates(seconds, steps),
                 "rows": len(table), "auc_min": min(aucs),
                 "auc_max": max(aucs),
                 "auroc": flipped_table(summary, levels)}
            results[tag] = r
            log(f"  {tag}: {json.dumps(r)}")
    if foreign_modules():
        raise AssertionError(f"loaded by phase 10: {foreign_modules()}")
    log("  pandas, scikit-learn, JAX and the JAX package not loaded")
    return results


def serve_mnar_model(device, epochs=MNAR_EPOCHS):
    """A MIMIC model trained with ``nan_skip='sample'`` and the presence
    penalty by ``fit_best`` on fold 0 of the first target, degraded at
    ``MNAR_SERVED_MISS``% as the MNAR pipeline degrades it; exported,
    loaded, and its flipped-class degraded test rows served through K1."""
    from multimodn_tpu_torch.data import MIMICDataset
    from multimodn_tpu_torch.pipelines.mimic import common
    from multimodn_tpu_torch.pipelines.mimic. \
        mimic_single_task_mnar_missingness_pipeline import _mnar_indices

    with scratch_storage("chip_smoke_mnar_model_") as work:
        cfg = common.MimicConfig(synthetic_patients=MNAR_PATIENTS,
                                 nan_skip="sample",
                                 presence_penalty=MNAR_SERVED_LAMBDA)
        target, vd = cfg.targets[0], [f"vd_{k}" for k in range(1024)]
        synth = {"n_patients": cfg.synthetic_patients}
        base = MIMICDataset(cfg.sources, targets=[target],
                            synthetic_kwargs=synth)
        tr, va, te = next(common.patient_kfold_splits(
            base, cfg.nfold, 0, patient=common.joint_split_table(cfg)))
        idx = (_mnar_indices(base, tr, target, 1, MNAR_SERVED_MISS)
               + _mnar_indices(base, va, target, 1, MNAR_SERVED_MISS))
        ds = MIMICDataset(cfg.sources, targets=[target], put_none=True,
                          indices_to_nan=idx, features_to_nan=vd,
                          synthetic_kwargs=synth).partition_dataset(
                              base.partitions)
        model = common.build_modn(cfg, base.partitions, [target], 0, device)
        torch.cuda.synchronize()
        FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
        t0 = time.perf_counter()
        info = model.fit_best(ArrayLoader(Subset(ds, tr), cfg.batch_size),
                              Adam(cfg.learning_rate), "cross_entropy",
                              epochs=epochs,
                              val_loader=ArrayLoader(Subset(ds, va),
                                                     cfg.batch_size))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        if (FUSED_CHAIN.launches, FUSED_ADAM.launches) != (0, 0):
            raise AssertionError("training launched a fused kernel")
        loaded = export_and_load(model, os.path.join(work, "export"), device,
                                 "mnar")
        if (loaded.presence_penalty, loaded.nan_skip) != \
                (MNAR_SERVED_LAMBDA, "sample"):
            raise AssertionError("the export lost the presence penalty")
        test = MIMICDataset(
            cfg.sources, targets=[target], put_none=True,
            indices_to_nan=_mnar_indices(base, te, target, 0,
                                         MNAR_SERVED_MISS),
            features_to_nan=vd, synthetic_kwargs=synth).partition_dataset(
                base.partitions)
        r = serve_trained("mnar_sample_pp25", loaded,
                          request_batches(test, te), device)
    r.update({"miss_perc": MNAR_SERVED_MISS, "lambda": MNAR_SERVED_LAMBDA,
              "fit_best_s": fit_s, "epochs": epochs,
              "best_epoch": info["best_epoch"],
              "best_score": info["best_score"]})
    log(f"  K1 serving the lambda-trained MIMIC model: {json.dumps(r)}")
    return r


# Phase 11: the MIMIC transformer pipeline at full width, its model's
# export round trip, card against CPU for it and for a ViT at its
# constructor defaults, and a profile of its training step.
TRANSFORMER_PATIENTS, TRANSFORMER_EPOCHS, TRANSFORMER_LR = 120, 2, 1e-3
PROFILE_BATCHES = (16, 1024)


def transformer_cfg(**kw):
    from multimodn_tpu_torch.pipelines.mimic import common
    return common.MimicConfig(encoder_type="transformer", dropout=0.0, **kw)


def transformer_model(device, seed=0):
    """The MIMIC transformer pipeline's model: one ``TransformerEncoder``
    per source (embed 128, 4 heads, 2 layers, chunk 64), 2 heads."""
    from multimodn_tpu_torch.pipelines.mimic import common
    cfg = transformer_cfg()
    return common.build_modn(cfg, list(MIMIC_WIDTHS), cfg.targets, seed,
                             device)


def vit_model(device, seed=0):
    """A ``ViTEncoder`` at its constructor defaults (32x32x3 images, patch
    8, embed 256, 4 heads, 4 layers) and one MIMIC head."""
    from multimodn_tpu_torch.encoders import ViTEncoder
    return MultiModN(MIMIC_STATE, [ViTEncoder(MIMIC_STATE)],
                     [MLPDecoder(MIMIC_STATE, (MIMIC_HIDDEN,) * 2, 2)], 1.0,
                     0.0, seed=seed, device=device)


def random_dataset(widths, n, seed, n_targets=MIMIC_TARGETS,
                   missing=MISSING_RATE):
    """``n`` rows at ``widths`` with ``missing`` of the (row, modality)
    cells NaN, labels from the signs of the first features."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, sum(widths))).astype(np.float32)
    y = (X[:, :n_targets] > 0).astype(np.int64)
    offsets = np.cumsum((0,) + tuple(widths[:-1]))
    for off, w in zip(offsets, widths):
        X[rng.random(n) < missing, off:off + w] = np.nan
    return PartitionDataset(X, y, list(widths))


def card_against_cpu(make_model, widths, label, device, steps=3, batch=8):
    """The same weights answer the same rows and take ``steps`` Adam steps
    on the same batches on both devices; outputs within TOL, parameters
    within ``steps`` lr (Adam may move a near-zero gradient's parameter by
    up to lr per step the other way)."""
    gpu, cpu = make_model(device), make_model("cpu")
    cpu.load_state_dict(gpu.state_dict())
    ds = random_dataset(widths, steps * batch, seed=5,
                        n_targets=len(gpu.decoders))
    xs, _y, _ = ds.arrays()
    clean = [np.nan_to_num(m) for m in xs]
    out_err = max(float(np.abs(g - c).max()) for g, c in zip(
        gpu.predict_proba(clean), cpu.predict_proba(clean)))
    for m in (gpu, cpu):
        m.train_epoch(ArrayLoader(ds, batch), Adam(TRANSFORMER_LR),
                      "cross_entropy")
    err = max(float(np.abs(a - b).max()) for a, b in zip(
        tree_leaves(gpu.state_dict()), tree_leaves(cpu.state_dict())))
    r = {"outputs_max_abs_err": out_err, "params_max_abs_err": err,
         "steps": steps, "lr": TRANSFORMER_LR}
    log(f"  card vs CPU, {label}: {json.dumps(r)}")
    if not (out_err <= TOL and err <= steps * TRANSFORMER_LR):
        raise AssertionError(f"{label}: the card and the CPU disagree")
    return r


def run_transformer(device):
    """Phase 11."""
    from multimodn_tpu_torch.pipelines.mimic import common
    from multimodn_tpu_torch.pipelines.mimic import \
        mimic_transformer_pipeline

    if foreign_modules():
        raise AssertionError(f"loaded before phase 11: {foreign_modules()}")
    models, build = [], common.build_modn

    def recording_build(*args, **kwargs):
        models.append(build(*args, **kwargs))
        return models[-1]

    def undo_patches():
        clock.restore()
        common.build_modn = build

    clock = fold_clock()
    common.build_modn = recording_build
    with contextlib.ExitStack() as stack:
        stack.callback(undo_patches)
        work = stack.enter_context(scratch_storage("chip_smoke_transformer_"))
        torch.cuda.synchronize()
        FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
        t0 = time.perf_counter()
        rows = mimic_transformer_pipeline.main(
            ["-e", str(TRANSFORMER_EPOCHS)],
            transformer_cfg(synthetic_patients=TRANSFORMER_PATIENTS),
            device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seconds, steps = clock.take()
        if (FUSED_CHAIN.launches, FUSED_ADAM.launches) != (0, 0):
            raise AssertionError("the transformer pipeline launched a fused "
                                 "kernel")
        path = os.path.join(work, "store", "nips", "results",
                            "mimic_single_task_(auc + bac).csv")
        with open(path, newline="") as f:
            table = list(csv.DictReader(f))
        aucs = [float(r["auc"]) for r in table]
        if len(table) != 20 or len(rows) != 20:
            raise AssertionError(f"transformer pipeline: {len(table)} CSV "
                                 f"rows, {len(rows)} results; want 20")
        if not all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in aucs):
            raise AssertionError(f"transformer pipeline: AUROC {aucs}")
        tokens = [e.n_tokens for e in models[0].encoders]
        if tokens != [1, 16, 12, 2]:
            raise AssertionError(f"transformer models: tokens {tokens}")
        if not all(t.device.type == device.type for m in models
                   for t in tree_leaves(m.params)):
            raise AssertionError(f"transformer models: parameters off "
                                 f"{device}")
        n_params = sum(t.numel() for t in tree_leaves(models[0].params))
        pipeline = {"patients": TRANSFORMER_PATIENTS, "folds": 5,
                    "epochs": TRANSFORMER_EPOCHS, "wall_s": wall,
                    **fold_rates(seconds, steps), "rows": len(table),
                    "auc_min": min(aucs),
                    "auc_max": max(aucs), "tokens": tokens,
                    "parameters": n_params}
        log(f"  transformer pipeline: {json.dumps(pipeline)}")

        trained = models[-1]
        loaded = export_and_load(trained, os.path.join(work, "export"),
                                 device, "transformer")
        xs, _y, _ = random_dataset(MIMIC_WIDTHS, 64, seed=4,
                                   missing=0.0).arrays()
        equal = all(np.array_equal(a, b) for a, b in zip(
            loaded.predict_proba(xs), trained.predict_proba(xs)))
        if not equal:
            raise AssertionError("the reloaded transformer model answers "
                                 "differently")
        try:
            loaded.fused_forward(xs)
            raise AssertionError("fused_forward accepted attention encoders")
        except TypeError:
            pass
        log("  export -> load_model: predict_proba bit-equal; fused_forward "
            "raises TypeError (K1 takes MLP-family encoders only)")

    versus = {"transformer": card_against_cpu(
        transformer_model, MIMIC_WIDTHS, "MIMIC transformer model", device),
        "vit": card_against_cpu(vit_model, (32 * 32 * 3,),
                                "ViTEncoder at its defaults", device)}
    profiles = {}
    for B in PROFILE_BATCHES:
        loader = ArrayLoader(random_dataset(MIMIC_WIDTHS, 8 * B, seed=6), B)
        profiles[str(B)] = profile_steps(
            transformer_model(device), loader, Adam(TRANSFORMER_LR),
            f"MIMIC transformer, batch {B}, Adam")
    if foreign_modules():
        raise AssertionError(f"loaded by phase 11: {foreign_modules()}")
    return {"pipeline": pipeline, "card_vs_cpu": versus,
            "profile": profiles}


# Phase 12: resumable fits and the streaming and disk loaders at the MIMIC
# model's full width with Adam8bit (fp8): a child process SIGKILLed after a
# checkpoint and resumed here, streamed selection against ArrayLoaders, the
# disk loaders' batches, the single-task pipeline with resume_dir and with
# stream_folds, the resumed best model served through K1, and the rates.
RESUME_EPOCHS = 3
STREAM_RATE_BATCHES = {16: TRAIN_SAMPLES, 1024: 16 * 1024}
RESUME_PIPELINE_EPOCHS = 2
RESUME_CHILD_TIMEOUT = 600


def resume_loaders(train_set, val_set, kind):
    """The resumable runs' loaders over phase 6's cohort: shuffled
    ArrayLoaders for ``fit_best_resumable``, StreamingLoaders (or their
    fixed-order ArrayLoader twins) for ``fit_best_streaming``."""
    from multimodn_tpu_torch.data import StreamingLoader
    if kind == "array":
        return (ArrayLoader(train_set, TRAIN_BATCH, shuffle=True, seed=0),
                ArrayLoader(val_set, TRAIN_BATCH))
    cls = StreamingLoader if kind == "stream" else ArrayLoader
    return cls(train_set, TRAIN_BATCH), cls(val_set, TRAIN_BATCH)


def resumable_fit(kind, device, ckpt_dir, on_chunk=None):
    """``fit_best_resumable`` (``kind='array'``) or ``fit_best_streaming``
    with ``checkpoint_dir`` (``'stream'``), one checkpoint per epoch."""
    from multimodn_tpu_torch.checkpoint import fit_best_resumable
    from multimodn_tpu_torch.data import fit_best_streaming
    _ds, train_set, val_set = mimic_training_loaders()
    tr, va = resume_loaders(train_set, val_set, kind)
    model = mimic_model(device)
    history = MultiModNHistory([f"t{d}" for d in range(MIMIC_TARGETS)])
    if kind == "array":
        info = fit_best_resumable(model, tr, Adam8bit(ADAM_LR),
                                  "cross_entropy", epochs=RESUME_EPOCHS,
                                  checkpoint_dir=ckpt_dir, val_loader=va,
                                  chunk_epochs=1, history=history,
                                  on_chunk=on_chunk)
    else:
        info = fit_best_streaming(model, tr, Adam8bit(ADAM_LR),
                                  "cross_entropy", epochs=RESUME_EPOCHS,
                                  val_loader=va, history=history,
                                  checkpoint_dir=ckpt_dir,
                                  checkpoint_every=1, on_chunk=on_chunk)
    return model, info, tr


def resume_child(kind, ckpt_dir, device="cuda"):
    """A child process's run: SIGKILLed right after its first checkpoint
    lands (it never returns)."""
    def kill(done, total):
        os.kill(os.getpid(), signal.SIGKILL)

    resumable_fit(kind, torch.device(device), ckpt_dir, on_chunk=kill)
    raise AssertionError("the resumable fit wrote no checkpoint")


def kill_children(ckpt_root):
    """Both children at once, each SIGKILLed after its first checkpoint;
    returns their checkpoint directories."""
    dirs = {kind: os.path.join(ckpt_root, kind) for kind in ("array",
                                                             "stream")}
    procs = {kind: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--resume-child", kind,
         d], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for kind, d in dirs.items()}
    for kind, proc in procs.items():
        try:
            _out, err = proc.communicate(timeout=RESUME_CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"resume child {kind}: timed out")
        if proc.returncode != -signal.SIGKILL:
            raise AssertionError(f"resume child {kind}: exit "
                                 f"{proc.returncode}\n{err[-3000:]}")
    return dirs


def state_leaves(model):
    """Parameters, moment codes and scales of ``model``."""
    return [t.detach() for t in tree_leaves([model.params, model.opt_state])
            if t is not None]


def bit_mismatches(a, b):
    """Elements whose bits differ between two models' parameters and
    optimizer states (moment codes compared as uint8); raises when the two
    states do not hold the same leaves."""
    la, lb = state_leaves(a), state_leaves(b)
    if len(la) != len(lb):
        raise AssertionError(f"{len(la)} state leaves against {len(lb)}")
    n = 0
    for x, y in zip(la, lb):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(
                f"a {tuple(x.shape)} {x.dtype} leaf against a "
                f"{tuple(y.shape)} {y.dtype} one")
        bits = torch.uint8 if x.element_size() == 1 else torch.int32
        n += int((x.view(bits) != y.view(bits)).sum())
    return n


def check_resume(device, work):
    """Kill-and-resume for both resume paths, each against its
    uninterrupted run, and streamed selection against ArrayLoaders; the
    main path is each resumed call, with K2 counted over it alone."""
    from multimodn_tpu_torch.data import fit_best_streaming
    _ds, train_set, val_set = mimic_training_loaders()
    per_step = fa.launches_per_update(
        [tuple(t.shape) for t in tree_leaves(mimic_model(device).params)])
    t0 = time.perf_counter()
    dirs = kill_children(os.path.join(work, "ck"))
    children_s = time.perf_counter() - t0
    out = {"children_s": children_s}
    refs = {}
    # The uninterrupted runs: fit_best on the shuffled loaders; fit_best on
    # fixed-order ArrayLoaders and fit_best_streaming on the same rows.
    for kind in ("array", "fixed", "stream"):
        model = mimic_model(device)
        tr, va = resume_loaders(train_set, val_set, kind)
        if kind == "stream":
            info = fit_best_streaming(model, tr, Adam8bit(ADAM_LR),
                                      "cross_entropy", epochs=RESUME_EPOCHS,
                                      val_loader=va)
        else:
            info = model.fit_best(tr, Adam8bit(ADAM_LR), "cross_entropy",
                                  epochs=RESUME_EPOCHS, val_loader=va)
        refs[kind] = (model, info)
    torch.cuda.synchronize()
    mism = bit_mismatches(refs["fixed"][0], refs["stream"][0])
    scores_equal = np.array_equal(refs["fixed"][1]["scores"],
                                  refs["stream"][1]["scores"])
    out["stream_vs_array"] = {"mismatching_elements": mism,
                              "scores_equal": scores_equal,
                              "best_epoch": refs["stream"][1]["best_epoch"]}
    log(f"  fit_best_streaming vs fit_best on ArrayLoaders: "
        f"{json.dumps(out['stream_vs_array'])}")
    if mism or not scores_equal:
        raise AssertionError("streamed selection differs from fit_best on "
                             "ArrayLoaders of the same rows")
    resumed = {}
    for kind, ref in (("array", refs["array"]), ("stream", refs["stream"])):
        torch.cuda.synchronize()
        FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
        t0 = time.perf_counter()
        model, info, tr = resumable_fit(kind, device, dirs[kind])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = FUSED_ADAM.launches
        steps = (RESUME_EPOCHS - 1) * tr.n_batches
        r = {"resumed_epochs": RESUME_EPOCHS - 1, "steps": steps,
             "k2_launches": launches, "k1_launches": FUSED_CHAIN.launches,
             "wall_s": wall, "best_epoch": info["best_epoch"],
             "best_score": info["best_score"],
             "scores": [float(s) for s in info["scores"]],
             "mismatching_elements": bit_mismatches(model, ref[0]),
             "scores_equal": np.array_equal(info["scores"],
                                            ref[1]["scores"])}
        log(f"  {kind} resumed after SIGKILL: {json.dumps(r)}")
        if r["mismatching_elements"] or not r["scores_equal"] or \
                info["best_epoch"] != ref[1]["best_epoch"]:
            raise AssertionError(f"{kind}: the resumed run differs from the "
                                 f"uninterrupted one")
        if launches != per_step * steps or FUSED_CHAIN.launches:
            raise AssertionError(f"{kind}: K2 launched {launches} times for "
                                 f"{steps} steps of {per_step}")
        out[kind] = r
        resumed[kind] = model
    return out, resumed


def check_disk_loaders(work):
    """The validation split exported as a memmap matrix and as a CSV;
    both disk loaders' batches against the StreamingLoader's."""
    from multimodn_tpu_torch.data import (CSVStreamingLoader,
                                          NpyStreamingLoader,
                                          StreamingLoader,
                                          export_streaming_matrix)
    from multimodn_tpu_torch.data import native
    _ds, _train, val_set = mimic_training_loaders()
    t0 = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - t0
    npy, widths, n_targets = export_streaming_matrix(
        val_set, os.path.join(work, "val.npy"))
    matrix = np.load(npy)
    path = os.path.join(work, "val.csv")
    with open(path, "w") as f:
        f.write(",".join(f"c{j}" for j in range(matrix.shape[1])) + "\n")
        for row in matrix:
            f.write(",".join("" if np.isnan(v) else repr(float(v))
                             for v in row) + "\n")
    want = list(StreamingLoader(val_set, TRAIN_BATCH).iter_batches())
    out = {"native_build_s": build_s, "rows": int(matrix.shape[0]),
           "columns": int(matrix.shape[1]),
           "csv_bytes": os.path.getsize(path)}
    for name, loader in (
            ("npy", NpyStreamingLoader(npy, widths, n_targets, TRAIN_BATCH)),
            ("csv", CSVStreamingLoader(path, widths, n_targets,
                                       TRAIN_BATCH))):
        t0 = time.perf_counter()
        got = list(loader.iter_batches())
        read_s = time.perf_counter() - t0
        bad = sum(
            int(sum((~((a == b) | (np.isnan(a) & np.isnan(b)))).sum()
                    for a, b in zip(gd, wd)) + (gt != wt).sum()
                + (gm != wm).sum())
            for (gd, gt, gm), (wd, wt, wm) in zip(got, want))
        out[name] = {"batches": len(got), "mismatching_elements": bad,
                     "epoch_read_s": read_s}
        if len(got) != len(want) or bad:
            raise AssertionError(f"{name} loader: {bad} elements differ from "
                                 f"the StreamingLoader's batches")
    log(f"  disk loaders: {json.dumps(out)}")
    return out


def run_resume_pipelines(device, work):
    """The single-task MIMIC pipeline (120 patients, 5 folds) by default,
    with resume_dir, invoked again on that finished resume_dir (every fold
    resumed, no step taken), and with stream_folds: the results CSVs
    byte-equal."""
    from multimodn_tpu_torch.pipelines.mimic import common
    from multimodn_tpu_torch.pipelines.mimic import \
        mimic_single_task_pipeline as single
    out, texts = {}, {}
    resume = {"resume_dir": os.path.join(work, "pipeline_ck")}
    variants = ("resume_dir", "resume_dir_again", "stream_folds")
    for name, extra in (("default", {}), ("resume_dir", resume),
                        ("resume_dir_again", resume),
                        ("stream_folds", {"stream_folds": True})):
        store = os.path.join(work, "store_" + name)
        os.environ["MULTIMODN_STORAGE"] = store
        torch.cuda.synchronize()
        FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
        t0 = time.perf_counter()
        rows = single.main(["-e", str(RESUME_PIPELINE_EPOCHS)],
                           common.MimicConfig(**extra), device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(store, "nips", "results",
                               "mimic_single_task_(auc + bac).csv")) as f:
            texts[name] = f.read()
        out[name] = {"wall_s": wall, "rows": len(rows),
                     "launches": [FUSED_CHAIN.launches,
                                  FUSED_ADAM.launches]}
        if len(rows) != 20:
            raise AssertionError(f"single-task with {name}: {len(rows)} rows")
    for name in variants:
        out[name]["csv_equal_to_default"] = texts[name] == texts["default"]
    log(f"  single-task pipeline: {json.dumps(out)}")
    if not all(out[n]["csv_equal_to_default"] for n in variants):
        raise AssertionError("a results CSV differs from the default path's")
    done = []
    for path in glob.glob(os.path.join(resume["resume_dir"], "*", "*",
                                       "resume_best_latest.pkl")):
        with open(path, "rb") as f:
            done.append(pickle.load(f)["epoch"])
    out["resume_dir"]["finished_fold_payloads"] = done
    folds = out["resume_dir"]["rows"] // 2     # a MultiModN and a HAIM row
    if done != [RESUME_PIPELINE_EPOCHS] * folds:
        raise AssertionError(f"resume_dir holds fold payloads at epochs "
                             f"{done}, not {folds} finished folds")
    return out


def copy_overlap(prof, wall_ms):
    """Device time of the host-to-device copies, the share of it that ran
    while a kernel ran (the union of kernel intervals), and the kernels'
    busy share of the profiled epoch's ``wall_ms``."""
    copies, kernels = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if "Memcpy HtoD" in e.name:
            copies.append(span)
        elif "Memcpy" not in e.name and "Memset" not in e.name:
            kernels.append(span)
    union = []
    for s, t in sorted(kernels):
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], t)
        else:
            union.append([s, t])
    total = sum(t - s for s, t in copies)
    hidden = 0.0
    for s, t in copies:
        for u, v in union:
            hidden += max(0.0, min(t, v) - max(s, u))
    busy_ms = sum(v - u for u, v in union) / 1e3
    return {"copies": len(copies), "copy_ms": total / 1e3,
            "hidden_share": hidden / total if total else None,
            "kernel_busy_share": busy_ms / wall_ms if union else None}


def stream_rates(device):
    """Training steps/s over ArrayLoader and StreamingLoader batches of 16
    and 1024 (Adam8bit, one warm epoch, then one timed epoch each); the
    host's ms per streamed batch to assemble it, and to assemble and copy it
    (no training); the share of the streamed copies' device time that
    overlapped a kernel, and the kernels' busy share (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    from multimodn_tpu_torch.data import (StreamingLoader,
                                          train_epoch_streaming)
    from multimodn_tpu_torch.data.streaming import device_batches
    out = {}
    for B, n in STREAM_RATE_BATCHES.items():
        ds = random_dataset(MIMIC_WIDTHS, n, seed=8)
        r = {"samples": n}
        for kind in ("array", "stream"):
            model, opt = mimic_model(device), Adam8bit(ADAM_LR)
            loader = ArrayLoader(ds, B) if kind == "array" \
                else StreamingLoader(ds, B)

            def epoch():
                if kind == "array":
                    model.train_epoch(loader, opt, "cross_entropy")
                else:
                    train_epoch_streaming(model, loader, opt,
                                          "cross_entropy")
                torch.cuda.synchronize()

            epoch()
            t0 = time.perf_counter()
            epoch()
            r[f"{kind}_steps_per_s"] = loader.n_batches / (
                time.perf_counter() - t0)
            if kind == "stream":
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    epoch()
                    wall_ms = 1e3 * (time.perf_counter() - t0)
                r.update(copy_overlap(prof, wall_ms))
                t0 = time.perf_counter()
                n_batches = sum(1 for _ in loader.iter_batches())
                r["assemble_ms_per_batch"] = 1e3 * (
                    time.perf_counter() - t0) / n_batches
                t0 = time.perf_counter()
                for _ in device_batches(loader, device):
                    pass
                torch.cuda.synchronize()
                r["assemble_and_copy_ms_per_batch"] = 1e3 * (
                    time.perf_counter() - t0) / n_batches
        r["array_step_ms"] = 1e3 / r["array_steps_per_s"]
        r["stream_step_ms"] = 1e3 / r["stream_steps_per_s"]
        out[str(B)] = r
    log(f"  streamed vs ArrayLoader training: {json.dumps(out)}")
    return out


def payload_write_ms(model, loader, work, reps=5):
    """Median time of one resume payload write (the whole training state of
    the resumed MIMIC model), and its size."""
    from multimodn_tpu_torch import checkpoint
    path = os.path.join(work, "payload.pkl")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        checkpoint._write_resume_payload(
            path, model, RESUME_EPOCHS, None, loader,
            best={"params": model.state_dict(), "score": 0.0, "epoch": 0},
            scores=[0.0] * RESUME_EPOCHS)
        times.append(1e3 * (time.perf_counter() - t0))
    return {"ms": statistics.median(times), "bytes": os.path.getsize(path)}


def run_resume(device):
    """Phase 12."""
    if foreign_modules():
        raise AssertionError(f"loaded before phase 12: {foreign_modules()}")
    with scratch_storage("chip_smoke_resume_") as work:
        resume, resumed = check_resume(device, work)
        disk = check_disk_loaders(work)
        pipelines = run_resume_pipelines(device, work)
        loaded = export_and_load(resumed["array"],
                                 os.path.join(work, "export"), device,
                                 "resumed")
        served = serve_trained("resumed_best", loaded,
                               serving_requests(seed=12), device)
        log(f"  K1 serving the resumed best model: {json.dumps(served)}")
        _ds, train_set, val_set = mimic_training_loaders()
        write = payload_write_ms(resumed["array"],
                                 resume_loaders(train_set, val_set,
                                                "array")[0], work)
        log(f"  resume payload write: {json.dumps(write)}")
    rates = stream_rates(device)
    if foreign_modules():
        raise AssertionError(f"loaded by phase 12: {foreign_modules()}")
    return {"resume": resume, "disk": disk, "pipelines": pipelines,
            "served": served, "payload_write": write, "rates": rates}


# Phase 13: encoding orders. (a) The MIMIC model at full width with
# shuffle_mode: the auto plan takes the switch chain and draws an order per
# training batch. (b) The featurewise chain of RESULTS.md:213-220, one
# MLPFeatureEncoder(50, 32) per MIMIC feature (1901) and one MLPDecoder,
# trained with shuffle_mode (the scan chain) and on batches that each carry
# their own permutation of the features (per-batch sequences).
ORDERS_EPOCHS = 2
FEATUREWISE_E, FEATUREWISE_HIDDEN = sum(MIMIC_WIDTHS), 32
FEATUREWISE_SAMPLES, FEATUREWISE_BATCH = 256, 64
FEATUREWISE_EPOCHS, FEATUREWISE_MISSING = 2, 0.1
# One Adam8bit step from the same weights on the card and the CPU, an end
# to end check of the chain and its gradients (K2 itself is held bit for
# bit on these leaves by time_adam_featurewise): the first step moves a
# parameter by ~lr * sign(g), so a near-zero gradient that the two
# summation orders round to opposite signs differs by 2 lr, plus the fp8
# rounding of the moments (<10%).
STEP_TOL = 3 * ADAM_LR


def orders_mimic(device, work):
    """Phase 13 (a): ``fit_best`` with ``Adam8bit`` and ``shuffle_mode`` on
    phase 6's cohort (K2 once per step), 3 steps on the card against the
    CPU (both devices draw the same permutations), then the model exported,
    loaded and served through K1 against the plain chain."""
    ds, train_set, val_set = mimic_training_loaders()
    model = mimic_model(device, shuffle_mode=True)
    if model._chain_plan() != ("switch", True):
        raise AssertionError(f"MIMIC shuffle plan {model._chain_plan()}")
    train_loader = ArrayLoader(train_set, TRAIN_BATCH, shuffle=True, seed=0)
    history = MultiModNHistory([f"t{d}" for d in range(MIMIC_TARGETS)])
    torch.cuda.synchronize()
    FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
    t0 = time.perf_counter()
    best = model.fit_best(train_loader, Adam8bit(ADAM_LR), "cross_entropy",
                          epochs=ORDERS_EPOCHS,
                          val_loader=ArrayLoader(val_set, TRAIN_BATCH),
                          history=history)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k2, k1 = FUSED_ADAM.launches, FUSED_CHAIN.launches
    steps = best["epochs_ran"] * train_loader.n_batches
    per_step = fa.launches_per_update(
        [tuple(t.shape) for t in tree_leaves(model.params)])
    losses = [float(np.mean(g)) for g in history.loss["train"]]
    if k2 != per_step * steps or k1:
        raise AssertionError(f"shuffled MIMIC fit_best launched K2 {k2} "
                             f"times for {steps} steps of {per_step}, K1 "
                             f"{k1} times")
    if not np.isfinite(losses + list(best["scores"])).all():
        raise AssertionError(f"shuffled MIMIC: losses {losses}")
    gpu = mimic_model(device, seed=1, dropout=0.0, shuffle_mode=True)
    cpu = mimic_model("cpu", seed=1, dropout=0.0, shuffle_mode=True)
    cpu.load_state_dict(gpu.state_dict())
    subset = Subset(ds, train_set.indices[:3 * TRAIN_BATCH])
    for m in (gpu, cpu):
        m.train_epoch(ArrayLoader(subset, TRAIN_BATCH), Adam8bit(ADAM_LR),
                      "cross_entropy")
    err = param_err(gpu, cpu)
    if not err <= DEVICE_TOL:
        raise AssertionError(f"shuffled MIMIC: card and CPU differ by {err}")
    loaded = export_and_load(model, os.path.join(work, "mimic_shuffle"),
                             device, "mimic_shuffle")
    if (loaded.shuffle_mode, loaded.chain_mode) != (True, "auto"):
        raise AssertionError("the export lost the order options")
    served = serve_trained("mimic_shuffle", loaded, serving_requests(seed=3),
                           device)
    r = {"plan": list(model._chain_plan()), "epochs": best["epochs_ran"],
         "steps": steps, "fit_best_s": fit_s,
         "steps_per_s": steps / fit_s, "losses": losses,
         "best_epoch": best["best_epoch"], "best_score": best["best_score"],
         "k2_launches": k2, "k2_launches_per_step": per_step,
         "card_vs_cpu_3_steps_max_abs_err": err, "served": served}
    log(f"  shuffled MIMIC model: {json.dumps(r)}")
    return r


def param_err(a, b) -> float:
    return max(float(np.nan_to_num(np.abs(x - y), nan=np.inf).max())
               for x, y in zip(tree_leaves(a.state_dict()),
                               tree_leaves(b.state_dict())))


class BatchSequenced(PartitionDataset):
    """A partition dataset whose sample ``i`` carries the encoder order
    ``seqs[i]``."""

    def __init__(self, X, y, partitions, seqs):
        super().__init__(X, y, partitions)
        self.seqs = seqs

    def arrays(self):
        xs, t, _ = super().arrays()
        return xs, t, self.seqs


def featurewise_model(device, **kw):
    encoders = [MLPFeatureEncoder(MIMIC_STATE, FEATUREWISE_HIDDEN)
                for _ in range(FEATUREWISE_E)]
    return MultiModN(MIMIC_STATE, encoders,
                     [MLPDecoder(MIMIC_STATE, (MIMIC_HIDDEN,) * 2, 2)], 1.0,
                     0.0, seed=0, device=device, **kw)


def featurewise_data(sequences, seed=0, clean=False):
    """256 samples of 1901 one-feature modalities, 10% of the cells NaN
    (none with ``clean``), a label from the first 8 features; with
    ``sequences`` every batch of 64 carries its own permutation of the
    encoders."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(FEATUREWISE_SAMPLES, FEATUREWISE_E)) \
        .astype(np.float32)
    y = (X[:, :8].sum(axis=1) > 0).astype(np.int64)[:, None]
    missing = rng.random(X.shape) < FEATUREWISE_MISSING
    if not clean:
        X[missing] = np.nan
    parts = [1] * FEATUREWISE_E
    if not sequences:
        return PartitionDataset(X, y, parts)
    n_batches = FEATUREWISE_SAMPLES // FEATUREWISE_BATCH
    seqs = np.repeat(np.stack([rng.permutation(FEATUREWISE_E)
                               for _ in range(n_batches)]),
                     FEATUREWISE_BATCH, axis=0)
    return BatchSequenced(X, y, parts, seqs)


def orders_featurewise(device, label, sequences):
    """Phase 13 (b), one run: one ``Adam8bit`` step on the card against the
    same step on the CPU, ``fit`` for 2 epochs (steps/s, K2 launches per
    step), a profiled step, and ``predict_proba`` on NaN-free rows against
    the CPU with the trained weights."""
    kw = {} if sequences else {"shuffle_mode": True}
    ds = featurewise_data(sequences)
    model = featurewise_model(device, **kw)
    if model._chain_plan() != ("scan", not sequences):
        raise AssertionError(f"{label}: plan {model._chain_plan()}")
    shapes = [tuple(t.shape) for t in tree_leaves(model.params)]
    cpu = featurewise_model("cpu", **kw)
    cpu.load_state_dict(model.state_dict())
    first = Subset(ds, range(FEATUREWISE_BATCH))
    t0 = time.perf_counter()
    cpu.train_epoch(ArrayLoader(first, FEATUREWISE_BATCH), Adam8bit(ADAM_LR),
                    "cross_entropy")
    cpu_step_s = time.perf_counter() - t0
    optimizer = Adam8bit(ADAM_LR)
    model.train_epoch(ArrayLoader(first, FEATUREWISE_BATCH), optimizer,
                      "cross_entropy")
    step_err = param_err(model, cpu)
    if not step_err <= STEP_TOL:
        raise AssertionError(f"{label}: one step differs by {step_err}")
    loader = ArrayLoader(ds, FEATUREWISE_BATCH)
    history = MultiModNHistory(["y"])
    torch.cuda.synchronize()
    FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
    t0 = time.perf_counter()
    model.fit(loader, optimizer, "cross_entropy", epochs=FEATUREWISE_EPOCHS,
              history=history)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k2, k1 = FUSED_ADAM.launches, FUSED_CHAIN.launches
    steps = FEATUREWISE_EPOCHS * loader.n_batches
    per_step = fa.launches_per_update(shapes)
    if k2 != per_step * steps or k1:
        raise AssertionError(f"{label}: K2 {k2} launches for {steps} steps "
                             f"of {per_step}, K1 {k1}")
    losses = [float(np.mean(g)) for g in history.loss["train"]]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: losses {losses}")
    profile = profile_steps(model, ArrayLoader(first, FEATUREWISE_BATCH),
                            optimizer, f"featurewise {label}", "fused_adam",
                            warm_up=False)
    cpu.load_state_dict(model.state_dict())
    clean = featurewise_data(sequences, clean=True)
    ask = ArrayLoader(clean, FEATUREWISE_BATCH) if sequences else \
        [m[:FEATUREWISE_BATCH] for m in clean.arrays()[0]]
    pred_err = max(float(np.abs(g - c).max()) for g, c in zip(
        model.predict_proba(ask), cpu.predict_proba(ask)))
    if not pred_err <= TOL:
        raise AssertionError(f"{label}: predict differs by {pred_err}")
    r = {"plan": list(model._chain_plan()), "leaves": len(shapes),
         "steps": steps, "fit_s": fit_s, "steps_per_s": steps / fit_s,
         "losses": losses, "k2_launches": k2, "k2_launches_per_step":
         per_step, "cpu_step_s": cpu_step_s,
         "one_step_max_abs_err": step_err, "predict_max_abs_err": pred_err,
         "kernels_per_step": profile["kernels_per_step"],
         "device_busy_share": profile["device_busy_share"],
         "wall_ms_per_step": profile["wall_ms_per_step"],
         "device_ms_per_step": profile["device_ms_per_step"],
         "k2_profiled": profile["fused_adam"]}
    log(f"  featurewise, {label}: {json.dumps(r)}")
    return r, shapes


def time_adam_featurewise(shapes, gen, device):
    """K2 on the featurewise model's leaves (fp8, after one prior step):
    one update of all of them (a launch per 40 leaves) held bit for bit
    against the plain version, as phase 5 holds its cases; then its device
    time per update (CUDA events; two updates queued behind the sleep, so
    the host's table builds between launches count when they outlast the
    device), the plain version's, and the bytes bound."""
    b1, b2 = ADAM_BETAS
    leaves = [adam_leaf(s, "fp8", gen, device, prior_steps=1) + [None]
              for s in shapes]
    bad, err, checked = check_adam_leaves(leaves, "fp8")
    log(f"  K2 on the {len(leaves)} featurewise leaves: {bad} mismatching "
        f"elements, max abs err of p {err:.3e}, {checked} launches")
    if bad > 0 or checked != fa.launches_per_update(shapes):
        raise AssertionError(
            f"fused_adam disagrees with the plain version on the featurewise "
            f"leaves: {bad} elements of p, codes or scales differ "
            f"({checked} launches)")
    leaves = [tuple(leaf) for leaf in leaves]
    shapes = tuple(tuple(s) for s in shapes)

    def kernel():
        FUSED_ADAM.launch(leaves, shapes, lr=ADAM_LR, b1=b1, b2=b2,
                          eps=ADAM_EPS, fmt="fp8")

    before = FUSED_ADAM.launches
    ms = time_ms(kernel, reps=2, groups=3)
    launches = (FUSED_ADAM.launches - before) / 7
    plain_ms = time_ms(lambda: fa.multi_leaf_update_ref(
        leaves, lr=ADAM_LR, b1=b1, b2=b2, eps=ADAM_EPS, fmt="fp8"),
        reps=1, groups=1)
    bound_ms, bound_by, nbytes = adam_bound(shapes)
    if launches != fa.launches_per_update(shapes):
        raise AssertionError(f"K2: {launches} launches per update")
    return {"leaves": len(shapes), "mismatches": bad, "max_abs_err": err,
            "tolerance": ADAM_TOL, "ms": ms, "launches": launches,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes}


def run_orders(device):
    """Phase 13."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_orders_") as work:
        t0 = time.perf_counter()
        mimic = orders_mimic(device, work)
        mimic_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs, shapes = {}, None
    for label, sequences in (("shuffle_mode", False),
                             ("per_batch_sequences", True)):
        runs[label], shapes = orders_featurewise(device, label, sequences)
    featurewise_s = time.perf_counter() - t0
    adam = time_adam_featurewise(shapes, torch.Generator(
        device=device).manual_seed(13), device)
    log(f"  K2 on the featurewise leaves: {json.dumps(adam)}")
    return {"mimic": mimic, "featurewise": runs, "featurewise_adam": adam,
            "mimic_s": mimic_s, "featurewise_s": featurewise_s}


# Phase 14: the drop-in torch surface. (a) The reference-idiom quick-start
# (compat/examples/titanic_mlp_pipeline.py: torch Adam over
# model.parameters(), nn.CrossEntropyLoss, DataLoaders, an F.relu encoder)
# through compat.run_script on the card; (b) the MIMIC model at full width
# trained with torch.optim.Adam, a shuffled DataLoader and
# nn.CrossEntropyLoss by train_epoch + test and by fit_best, each bit-equal
# to the same run with the port's Adam and ArrayLoader; (c) the torch-trained
# MIMIC model and the F.relu-built quick-start model served through K1.
DROPIN_EPOCHS = 20
DROPIN_SCRIPT = os.path.join(ROOT, "multimodn_tpu_torch", "compat",
                             "examples", "titanic_mlp_pipeline.py")


def dropin_quickstart(device, work):
    """(a): the body for 20 epochs with ``-p false`` (no matplotlib on the
    card); its model, built without a device, must land on ``device``, the
    card. Returns the record and the pickled model."""
    from multimodn_tpu_torch import compat
    from multimodn_tpu_torch.core.nn import activation_name
    from multimodn_tpu_torch.pipelines.titanic import common
    path = os.path.join(work, os.path.basename(DROPIN_SCRIPT))
    shutil.copy(DROPIN_SCRIPT, path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compat.run_script(path, ["-e", str(DROPIN_EPOCHS), "-p", "false"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loaded = []
    for name in ("titanic_mlp_model.pkl", "titanic_mlp_history.pkl"):
        with open(os.path.join(work, "models", name), "rb") as f:
            loaded.append(pickle.load(f))
    model, history = loaded
    if model.device.type != device.type or not all(
            t.device.type == device.type for t in tree_leaves(model.params)):
        raise AssertionError(f"quick-start body: model on {model.device}")
    if activation_name(model.encoders[0].activation) != "relu":
        raise AssertionError("quick-start body: F.relu did not map to relu")
    losses = mean_losses(history, "train")
    if len(losses) != DROPIN_EPOCHS or not np.isfinite(
            losses + mean_losses(history, "val")).all() or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"quick-start body: train losses {losses}")
    with open(os.path.join(work, "results", "titanic_mlp.csv"),
              newline="") as f:
        rows = list(csv.reader(f))
    if rows[0][0] != "Target" or len(rows) != 2:
        raise AssertionError(f"quick-start body: results CSV {rows[:2]}")
    cfg = titanic_pipeline("titanic_mlp").CONFIG
    train, _val, _ = common.split(cfg, 0)
    steps = DROPIN_EPOCHS * common.loader(cfg, train).n_batches
    r = {"epochs": DROPIN_EPOCHS, "wall_s": wall, "steps": steps,
         "steps_per_s": steps / wall, "first_train_loss": losses[0],
         "last_train_loss": losses[-1],
         "last_val_loss": mean_losses(history, "val")[-1],
         "device": str(model.device)}
    log(f"  reference-idiom quick-start through run_script: {json.dumps(r)}")
    return r, model


def dropin_mimic_run(device, torch_objects, loop, train_set, val_set):
    """One 3-epoch run of the MIMIC model: torch objects or the port's own,
    by a train_epoch + test loop or by fit_best; wall time synchronised."""
    import torch.nn as nn
    import torch.utils.data as tud
    model = mimic_model(device)
    if torch_objects:
        optimizer = torch.optim.Adam(list(model.parameters()), ADAM_LR)
        train = tud.DataLoader(train_set, TRAIN_BATCH, shuffle=True)
        val = tud.DataLoader(val_set, TRAIN_BATCH)
        criterion = nn.CrossEntropyLoss()
    else:
        optimizer = Adam(ADAM_LR)
        train = ArrayLoader(train_set, TRAIN_BATCH, shuffle=True, seed=0)
        val = ArrayLoader(val_set, TRAIN_BATCH)
        criterion = "cross_entropy"
    history = MultiModNHistory([f"t{d}" for d in range(MIMIC_TARGETS)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = None
    if loop:
        for _ in range(TRAIN_EPOCHS):
            model.train_epoch(train, optimizer, criterion, history)
            model.test(val, criterion, history, tag="val")
    else:
        info = model.fit_best(train, optimizer, criterion,
                              epochs=TRAIN_EPOCHS, val_loader=val,
                              history=history)
    torch.cuda.synchronize()
    return model, history, info, time.perf_counter() - t0


def history_mismatches(a, b) -> int:
    """History arrays (every metric and tag, the state change) that are not
    bit-equal."""
    pairs = [(x, y) for f in ("loss", "accuracy", "sensitivity",
                              "specificity", "balanced_accuracy")
             for tag in getattr(b, f)
             for x, y in zip(getattr(a, f).get(tag, []), getattr(b, f)[tag])]
    pairs += list(zip(a.state_change_loss, b.state_change_loss))
    return sum(not np.array_equal(x, y, equal_nan=True) for x, y in pairs)


def dropin_mimic(device):
    """(b): for the loop and for fit_best, the torch-object run against the
    native one (torch, native, native, torch), parameters, history and
    selection bit for bit; steps/s of each (validation passes included)."""
    _ds, train_set, val_set = mimic_training_loaders()
    steps = TRAIN_EPOCHS * -(-TRAIN_SAMPLES // TRAIN_BATCH)
    runs = {}
    for label, torch_objects, loop in (
            ("loop_torch", True, True), ("loop_native", False, True),
            ("fit_best_native", False, False),
            ("fit_best_torch", True, False)):
        runs[label] = dropin_mimic_run(device, torch_objects, loop,
                                       train_set, val_set)
    out = {"steps": steps}
    for kind in ("loop", "fit_best"):
        (tm, th, ti, tw), (nm, nh, ni, nw) = runs[f"{kind}_torch"], \
            runs[f"{kind}_native"]
        bad = bit_mismatches(tm, nm)
        bad_hist = history_mismatches(th, nh)
        same_selection = ti is None or (
            np.array_equal(ti["scores"], ni["scores"])
            and ti["best_epoch"] == ni["best_epoch"])
        losses = mean_losses(th, "train")
        r = {"torch_steps_per_s": steps / tw, "native_steps_per_s":
             steps / nw, "torch_wall_s": tw, "native_wall_s": nw,
             "mismatching_elements": bad, "mismatching_history_arrays":
             bad_hist, "train_losses": losses}
        if ti is not None:
            r.update(best_epoch=ti["best_epoch"],
                     best_score=ti["best_score"])
        log(f"  MIMIC {kind}, torch objects against the port's: "
            f"{json.dumps(r)}")
        if bad or bad_hist or not same_selection:
            raise AssertionError(
                f"MIMIC {kind}: torch objects differ from the port's own "
                f"({bad} elements, {bad_hist} history arrays, selection "
                f"equal {same_selection})")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"MIMIC {kind}: train losses {losses}")
        out[kind] = r
    return out, runs["loop_torch"][0]


def run_dropin(device):
    """Phase 14."""
    if foreign_modules():
        raise AssertionError(f"loaded before phase 14: {foreign_modules()}")
    work = tempfile.mkdtemp(prefix="chip_smoke_dropin_")
    try:
        torch.cuda.synchronize()
        FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
        quick, quick_model = dropin_quickstart(device, work)
        mimic, mimic_model_trained = dropin_mimic(device)
        torch.cuda.synchronize()
        if (FUSED_CHAIN.launches, FUSED_ADAM.launches) != (0, 0):
            raise AssertionError(
                f"torch-object training launched the fused kernels "
                f"{(FUSED_CHAIN.launches, FUSED_ADAM.launches)} times; it "
                f"runs the plain chain and Adam")
        served = {}
        for label, name, model, requests in (
                ("MIMIC, torch-trained", "dropin_mimic", mimic_model_trained,
                 serving_requests(seed=14)),
                ("S=1, MLPEncoder(1, 6, (5, 5), F.relu)", "dropin_titanic",
                 quick_model, serving_requests(seed=15, widths=(6,)))):
            loaded = export_and_load(model, os.path.join(work, "export",
                                                         name), device, name)
            r = serve_trained(name, loaded, requests, device)
            log(f"  K1 serving the {label} model: {json.dumps(r)}")
            served[label] = r
        mimic_served = served["MIMIC, torch-trained"]
        if mimic_served["launches_per_request"] != 2:
            raise AssertionError(f"K1 plan at MIMIC width: "
                                 f"{mimic_served['launches_per_request']} "
                                 f"launches per request")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if foreign_modules():
        raise AssertionError(f"loaded by phase 14: {foreign_modules()}")
    return {"quickstart": quick, "mimic": mimic, "served": served}


def build_kernels():
    """Build every kernel library at once (one nvcc per source)."""
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [pool.submit(k.library) for k in (FUSED_CHAIN, FUSED_ADAM)]
        for f in futures:
            f.result()
    for name in ("fused_chain.cu", "fused_adam.cu"):
        with open(library_path(name) + ".log") as f:
            log(name + ": " + " ".join(
                line.strip() for line in f
                if "registers" in line or "spill" in line))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--protocol-only", action="store_true",
                   help="run phases 1 and 8 only and end with the protocol "
                        "line (no kernel build, no ok line)")
    p.add_argument("--patients", type=int, default=None,
                   help="synthetic patients in phase 8 (default: the "
                        "pipelines' own)")
    p.add_argument("--mnar-only", action="store_true",
                   help="run phase 1 and the MNAR protocol grid at the "
                        "published scale (300 patients, 5 folds; batch, "
                        "sample, sample + lambda 25) only, --epochs deep")
    p.add_argument("--variants", nargs="+", default=None,
                   metavar="NAN_SKIP[:LAMBDA]",
                   help="with --mnar-only: the variants to run (default: "
                        "batch sample sample:25)")
    p.add_argument("--epochs", type=int, default=PROTOCOL_EPOCHS,
                   help="epochs of each fold in phase 8 (and of the grid "
                        "with --mnar-only)")
    p.add_argument("--stream-folds", action="store_true",
                   help="with --protocol-only: stream every fold's batches "
                        "(MimicConfig.stream_folds)")
    p.add_argument("--orders-only", action="store_true",
                   help="run phases 1, 2 and 13 (encoding orders) only and "
                        "end with the orders line (no ok line)")
    p.add_argument("--dropin-only", action="store_true",
                   help="run phases 1, 2 and 14 (the drop-in torch surface) "
                        "only and end with the dropin line (no ok line)")
    p.add_argument("--resume-child", nargs=2, metavar=("KIND", "DIR"),
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def exact_math():
    """No TF32 anywhere: the card's products are fp32, as in the plain
    versions and every comparison here."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    exact_math()
    if args.resume_child:
        resume_child(*args.resume_child)

    log("== phase 1: device")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    if args.protocol_only:
        log("== phase 8: MIMIC protocol"
            + (", streamed folds" if args.stream_folds else ""))
        protocol = run_protocol(device, args.patients, args.epochs,
                                stream_folds=args.stream_folds)
        log("protocol: " + json.dumps(protocol))
        log(f"chip_smoke wall time {time.perf_counter() - START:.1f} s")
        log(card)
        return 0
    if args.mnar_only:
        log("== phase 10: MNAR protocol grid")
        variants = MNAR_FULL_VARIANTS if args.variants is None else [
            (v.split(":")[0], float(v.split(":")[1]) if ":" in v else 0.0)
            for v in args.variants]
        mnar = run_mnar(device, args.patients or MNAR_FULL_PATIENTS,
                        MNAR_FULL_FOLDS, args.epochs, variants)
        log("mnar: " + json.dumps(mnar))
        log(f"chip_smoke wall time {time.perf_counter() - START:.1f} s")
        log(card)
        return 0

    log("== phase 2: build")
    t0 = time.perf_counter()
    build_kernels()
    log(f"fused_chain.cu and fused_adam.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    if args.orders_only:
        log("== phase 13: encoding orders")
        log("orders: " + json.dumps(run_orders(device)))
        log(f"chip_smoke wall time {time.perf_counter() - START:.1f} s")
        log(card)
        return 0
    if args.dropin_only:
        log("== phase 14: drop-in torch surface")
        log("dropin: " + json.dumps(run_dropin(device)))
        log(f"chip_smoke wall time {time.perf_counter() - START:.1f} s")
        log(card)
        return 0

    log("== phase 3: kernel against plain")
    log(f"tolerance {TOL:g}: {TOL_REASON}")
    gen = torch.Generator(device=device).manual_seed(0)
    mimic = check_kernel("mimic", mimic_model(device), KERNEL_BATCHES, gen)
    check_kernel("small-last-concat", small_model(device), (7, 1000), gen)

    log("== phase 4: serving")
    launches, serving = serve(device)

    log("== phase 5: fused Adam kernel against plain")
    log(f"tolerance {ADAM_TOL:g}: {ADAM_TOL_REASON}")
    adam = check_adam(device, gen)

    log("== phase 6: training")
    runs = check_training(device)
    profile = profile_training(device)

    log("== phase 7: card against CPU")
    device_err = check_device_vs_cpu(device)

    log("== phase 8: MIMIC protocol")
    log(card_line())
    protocol = run_protocol(device, args.patients, args.epochs)

    log("== phase 9: Titanic")
    log(card_line())
    titanic = run_titanic(device)

    log("== phase 10: MNAR protocol")
    log(card_line())
    mnar = run_mnar(device, MNAR_PATIENTS, MNAR_FOLDS, MNAR_EPOCHS,
                    MNAR_VARIANTS)
    mnar_served = serve_mnar_model(device)

    log("== phase 11: transformer")
    log(card_line())
    transformer = run_transformer(device)

    log("== phase 12: resumable fits, streaming and disk loaders")
    log(card_line())
    resume = run_resume(device)

    log("== phase 13: encoding orders")
    log(card_line())
    orders = run_orders(device)

    log("== phase 14: drop-in torch surface")
    log(card_line())
    dropin = run_dropin(device)
    k1_by_phase = {
        "4": launches,
        "9": sum(r["launches"] for r in titanic["served"].values()),
        "10": mnar_served["launches"],
        "12": resume["served"]["launches"],
        "13": orders["mimic"]["served"]["launches"],
        "14": sum(r["launches"] for r in dropin["served"].values())}
    k2_by_phase = {
        "6": runs["Adam8bit"]["launches"],
        "12": sum(resume["resume"][kind]["k2_launches"]
                  for kind in ("array", "stream")),
        "13": orders["mimic"]["k2_launches"] + sum(
            r["k2_launches"] for r in orders["featurewise"].values())}

    main_b = mimic[SERVING_BATCH]
    entry = {
        "name": "fused_chain",
        "route": "cuda",
        "source": "multimodn_tpu_torch/csrc/fused_chain.cu",
        "replaces": "multimodn_tpu/ops/fused_chain.py:132",
        "launches": sum(k1_by_phase.values()),
        "launches_by_phase": k1_by_phase,
        "max_abs_err": max(r["max_abs_err"] for r in mimic.values()),
        "tolerance": TOL,
        "ms": main_b["ms"],
        "plain_ms": main_b["plain_ms"],
        "bound_ms": main_b["bound_ms"],
        "bound_by": main_b["bound_by"],
        # No single PyTorch call computes the whole chain.
        "library_ms": None,
        "batch": SERVING_BATCH,
        "serving": serving,
        "by_batch": {str(B): {k: r[k] for k in (
            "max_abs_err", "ms", "launches", "plain_ms", "bound_ms",
            "bound_by", "stage_ms", "small_tiles_ms") if k in r}
                     for B, r in mimic.items()},
        "titanic": {label: {k: r[k] for k in (
            "pipeline", "requests", "launches", "launches_per_request",
            "max_abs_err", "batch", "ms", "plain_ms", "bound_ms",
            "bound_by")} for label, r in titanic["served"].items()},
        "mnar": {k: mnar_served[k] for k in (
            "pipeline", "requests", "launches", "launches_per_request",
            "max_abs_err", "batch", "ms", "plain_ms", "bound_ms",
            "bound_by")},
        "resumed": {k: resume["served"][k] for k in (
            "pipeline", "requests", "launches", "launches_per_request",
            "max_abs_err", "batch", "ms", "plain_ms", "bound_ms",
            "bound_by")},
        "orders": {k: orders["mimic"]["served"][k] for k in (
            "pipeline", "requests", "launches", "launches_per_request",
            "max_abs_err", "batch", "ms", "plain_ms", "bound_ms",
            "bound_by")},
        "dropin": {label: {k: r[k] for k in (
            "pipeline", "requests", "launches", "launches_per_request",
            "max_abs_err", "batch", "ms", "plain_ms", "bound_ms",
            "bound_by")} for label, r in dropin["served"].items()},
    }
    step = adam["times"]["mimic_step"]
    adam_entry = {
        "name": "fused_adam",
        "route": "cuda",
        "source": "multimodn_tpu_torch/csrc/fused_adam.cu",
        "replaces": "multimodn_tpu/ops/fused_adam.py:151",
        "launches": sum(k2_by_phase.values()),
        "launches_by_phase": k2_by_phase,
        "max_abs_err": adam["max_abs_err"],
        "mismatches": adam["mismatches"],
        "tolerance": ADAM_TOL,
        # One optimizer step of the MIMIC model: all 37 leaves.
        "ms": step["ms"],
        "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"],
        "bound_by": step["bound_by"],
        # No PyTorch call computes an 8-bit quantized Adam update.
        "library_ms": None,
        "leaves_per_step": adam["n_leaves"],
        "launches_per_step": adam["launches_per_step"],
        "steps": runs["Adam8bit"]["steps"],
        "by_shape": adam["times"],
        "training": {name: {k: r[k] for k in (
            "train_step_ms", "train_epoch_ms", "fit_best_ms_per_epoch",
            "losses", "best_epoch", "best_score")}
            for name, r in runs.items()},
        "training_profile": profile,
        "device_vs_cpu_max_abs_err": device_err,
        "resume": {kind: {k: resume["resume"][kind][k] for k in (
            "k2_launches", "steps", "mismatching_elements")}
            for kind in ("array", "stream")},
        "orders": {
            "mimic_shuffle": {k: orders["mimic"][k] for k in (
                "k2_launches", "steps", "k2_launches_per_step")},
            "featurewise": {label: {k: r[k] for k in (
                "k2_launches", "steps", "k2_launches_per_step", "leaves",
                "k2_profiled")} for label, r in
                orders["featurewise"].items()},
            "featurewise_update": orders["featurewise_adam"]},
    }
    log("earlier designs (not measured in this run): "
        + json.dumps(EARLIER))
    log("protocol: " + json.dumps(protocol))
    log("titanic: " + json.dumps({k: titanic[k] for k in (
        "pipelines", "quickstart", "profile")}))
    log("mnar: " + json.dumps({"protocol": mnar, "served": mnar_served}))
    log("transformer: " + json.dumps(transformer))
    log("resume: " + json.dumps({k: resume[k] for k in (
        "resume", "disk", "pipelines", "payload_write", "rates")}))
    log("orders: " + json.dumps(orders))
    log("dropin: " + json.dumps(dropin))
    log(json.dumps({"kernels": [entry, adam_entry]}))
    log(f"chip_smoke wall time {time.perf_counter() - START:.1f} s")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
