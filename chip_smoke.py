#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``multimodn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --all-protocols [--patients N --epochs N --nfold N --stages 1 2 3 4 --keep DIR]
    python3 chip_smoke.py --orders-only
    python3 chip_smoke.py --dropin-only
    python3 chip_smoke.py --experiments-only
    python3 chip_smoke.py --precision-only
    python3 chip_smoke.py --parallel-only
    python3 chip_smoke.py --vjp-only
    python3 chip_smoke.py --chain-only
    python3 chip_smoke.py --adam-only

The first form is the smoke run; the second runs phase 8 alone, the
published-protocol runner at the published scale (300 patients, 100
epochs, 5 folds, all four stages) or at the values given; the third
phase 13 alone, the fourth phase 14 alone, the fifth phase 15 alone, the
sixth phase 16 alone, the seventh phases 17 and 18 alone, the eighth
phase 19 alone, the ninth phase 20 at its full set (``CHAIN_CONFIGS``),
the tenth phase 5 alone.
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
   four); then the fp32 Adam kernel (K3): ``Adam`` through it against
   ``Adam.update`` plus ``add_`` (the per-leaf PyTorch update) on the
   133 leaves of the benchmark's image-model cell (a ResNet-18 among the
   MIMIC encoders), 3 steps, gated and not, float32 and bfloat16 moments:
   parameters and moments bit-equal, one launch a step; K3's time (CUDA
   events) beside its bound, and per step the host and device time and the
   kernels of ``fused_apply`` and of the per-leaf update;
6. training at full width: ``fit_best`` with ``Adam8bit`` for 3 epochs of
   batch 16 on seeded synthetic MIMIC-width data (30% of modality cells
   missing), then ``test``; every loss finite, the third epoch's training
   loss below the first's, and the fused Adam kernel launched as often per
   step as its leaf table says (once at MIMIC width); the same run with
   ``Adam`` is timed beside it, K3 launched once a step and K2 never,
   and ``torch.profiler`` splits a few steps into device and host time,
   read from the profiler's device events and, on the same trace, through
   ``key_averages()``;
7. the card against the CPU: the same weights take 3 ``Adam8bit`` steps on
   the same batches on both devices and must agree;
8. the published-protocol runner (``pipelines/mimic/all_protocols.py``,
   the port of ``nips/run_all_protocols.py``) at the MIMIC model's full
   width on 120 synthetic patients, 2 folds and 2 epochs, in a temporary
   storage directory: its four stages (single-task and multi-task, 2
   targets; the MNAR grid of six missingness levels with the batch skip,
   then with the per-sample skip), each started as in a process of its own
   (no parse kept). Each stage's CSV must hold 2 targets x folds x 2
   models rows (x 11 tests for MNAR), every AUROC finite and in [0, 1],
   the MNAR rows and summary (22 groups) their counts, every MultiModN and
   HAIM parameter on the card, and neither pandas, scikit-learn, JAX nor
   the JAX package loaded. Each stage's wall time splits into data and
   cache build, MultiModN folds and HAIM folds (and the MNAR levels), with
   training steps per second and the cache files' parses; every cache file
   a stage parsed must go through the native reader (``native/csv.cpp``)
   and read again bit-equal through the Python parse (NaN where NaN),
   whose seconds are printed beside the native parse's. Each target's mean
   and fold spread of test AUROC (the MNAR flipped-class table) stand
   beside the JAX package's committed rows in ``nips/results/``. No kernel
   is on this path (the protocol trains with ``Adam`` and tests through
   the plain chain, as the JAX package's does): both launch counters must
   read 0 after each stage;
9. the Titanic quick-start and its pipelines: the port's six Titanic
   pipelines at 5 epochs (the reference's smoke depth) with the results
   CSV written in a temporary directory, plots and pickles off; then the
   port's quick-start (``examples/quickstart.py``'s ``main``) for 100 of
   its published 300 epochs of ``fit``, then ``test``, the last epoch's
   training loss below the first's, its session's probabilities the
   model's own and its artifact's reload answering as the model; then
   the trained quick-start, partitioned, featurewise and
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
10. a MIMIC model trained by ``fit_best`` with ``nan_skip='sample'`` and
   the presence penalty (lambda 25) on an 80%-degraded fold goes through
   ``export_model`` -> ``load_model`` and serves its flipped-class test
   rows through K1, launches counted, held against the plain chain;
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
   trained 1 epoch with ``Adam8bit``, once with ``shuffle_mode`` (the scan
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
15. the experiment surface and ahead-of-time serving at the MIMIC model's
   full width on phase 6's cohort: ``sweep_fit_best`` over 2 seeds with
   ``Adam8bit``, 2 epochs of batch 16, ``on_epoch`` set (K2 once per step of
   every seed; each seed bit-equal, parameters, moment codes, scales,
   scores and best epoch, to that seed's own ``fit_best`` on a fresh
   loader), steps/s; ``kfold_fit_best`` over 2 folds with ``on_epoch`` and
   ``patience`` 1 (payloads fold after fold, ``fold_history``); seed 0's
   best model through ``export_compiled`` (traced on the CPU) ->
   ``load_compiled`` onto the card (also by default), answering requests
   of 1, 16 and 32 rows with NaN cells within 1e-4 of K1's
   ``fused_forward`` (launches counted) and 1e-5 of the plain chain with
   the skip, and the artifact's warm p50 per request of 16 beside K1's, in
   turns; ``utils.profiling.trace`` around 8 training steps under
   ``annotate`` (the trace must name the region); the port of
   ``examples/production_features.py`` on the card;
16. mixed precision and the ResNet-18 image encoder: (a) the MIMIC model
   at full width with ``compute_dtype='bfloat16'``, ``fit_best`` for 2
   epochs of batch 16 on phase 6's cohort with ``Adam8bit`` (K2 once per
   step; masters fp32), its final training loss within the JAX package's
   bound (rtol 0.05, atol 0.02) of the same run in fp32, one step on the
   card against the CPU, and the model through ``export_model`` ->
   ``load_model`` (the dtype kept) serving 8 requests of 16 rows with NaN
   rows through K1 in fp32 against the plain chain, launches counted;
   (b) ``Adam(state_dtype=torch.bfloat16)`` on that model for 1 epoch
   (bf16 moments, finite losses); (c) the MIMIC transformer model of
   phase 11 in bf16 beside fp32 at batch 16 and 1024: steps/s, kernels per
   step, device ms and busy share from ``utils.profiling.trace`` (recorded,
   not checked); (d) a ``ResNet(state_size=50)`` over 224 x 224 x 3 NHWC
   images, 30% of them NaN, beside a ``MIMICMLPEncoder`` over the 1024-wide
   source, 2 ``MLPDecoder``s: K2 bit for bit against its plain version on
   one update of all 102 ResNet leaves in both code formats, timed beside
   it and its bound; ``fit_best`` for 2 epochs of batch 32 over 256 rows in
   fp32 and in bf16 with ``Adam8bit`` (K2 launches per step from the leaf
   table), the present rows' states unmoved when NaN images' pixels change
   (masked BatchNorm), ``update_batch_stats`` then evaluation-mode
   ``predict_proba``, one fp32 step on the card against the CPU and
   evaluation outputs against the CPU;
17. multi-GPU parity (``multimodn_tpu_torch.parallel``) on the one card,
   the MIMIC model at full width (dropout 0.2) on 512 + 128 seeded rows
   (30% of cells missing), batch 16, ``fit_best`` for 2 epochs with
   ``Adam8bit``: (a) one rank in a NCCL group in this process,
   ``MultiModN(mesh=make_mesh())`` under both ``dp_engine``s bit-equal to
   the mesh-free run beside it (parameters, 8-bit states, scores, grids),
   K2 once per step, steps/s of each; (b) two ranks on the card over
   ``gloo`` (``parallel.dryrun.spawn``; NCCL refuses two ranks on one
   device): a ``data`` axis of 2 under ``nan_skip`` 'sample' and 'batch'
   (one batch's NaNs in the second rank's rows only), ``('data', 'model')
   = (1, 2)``, and both meshes again with fp32 ``Adam``; the ranks'
   replicas bit-equal, per-epoch loss grids against (a) (rtol 1e-5,
   Adam8bit's later epochs rtol 1e-2), the fp32 ``Adam`` runs' parameters
   too (rtol 1e-5, atol 1e-6), K2 launches per step (1, or 2 in the
   cross-rank form),
   steps/s and collective ms per step from ``utils.profiling.trace``; K2's
   cross-rank form bit-equal to the plain update of the whole leaves,
   sliced, on all 37 sharded MIMIC leaves in one call, on (4096, 1024)
   split 2 ways and on a NaN row, timed with and without its gloo MAX;
   (c) K1 serving the model-axis model's gathered weights, 8 requests,
   2 launches each per rank, within 1e-4 of the plain chain; (d) a
   fold-axis ``kfold_fit_best`` (2 folds) and a seed-axis
   ``sweep_fit_best`` (2 seeds) over the two ranks, bit-equal to one
   rank's; a 2-rank ``fit_best_resumable`` stopped after one epoch and
   resumed on 2 ranks bit-equal to the uninterrupted run, and resumed on
   one rank (elastic) with losses within rtol 1e-2; the same elastic
   resume with fp32 ``Adam`` within rtol 1e-5 in every epoch's losses and
   in its parameters (atol 1e-6);
18. every encoder on a mesh, two ranks on the card over ``gloo`` against
   the same model on one rank (``fit_best``, 2 epochs, each run's K2
   launches, steps/s and collective ms per step from
   ``utils.profiling.trace``): the MIMIC transformer pipeline's model
   (phase 11's, 1,656,140 parameters; 128 + 32 seeded rows, batch 16) on
   ``('data', 'model') = (1, 2)`` and on ``data`` = 2 with fp32 ``Adam``,
   and on (1, 2) with ``Adam8bit`` (K2's cross-rank form, 2 launches per
   step); phase 16's ResNet-18 image model (224 x 224 x 3, 64 + 32 rows,
   batch 32, the NaN images in the second rank's rows only) on ``data`` = 2
   (global BatchNorm moments) and on (1, 2) with fp32 ``Adam``, and on (1,
   2) with ``Adam8bit``; the Titanic LSTM pipeline's model (unbatched
   recurrence over the global batch) on ``data`` = 2 with ``Adam``. Replicas
   bit-equal; fp32 ``Adam`` losses within rtol 1e-5 of one rank's in every
   epoch and each parameter leaf within rtol 1e-5 of its largest magnitude
   (atol 1e-6), or, for the transformer and image models, within 4x the
   distance that reversing each batch's rows puts between two one-rank
   runs in this run (``ENC_FLOOR_FACTOR``); ``Adam8bit`` losses within rtol
   1e-5 in the first epoch and 1e-2 after; K2 launches per step as the
   leaf table says; and K2's cross-rank form on one optimizer step of
   each model's leaves (split pieces beside whole leaves, the ResNet's 4-D
   kernels among them) bit-equal to the plain update of the whole leaves,
   sliced, timed with and without its gloo MAX against its bound;
19. K1 with a gradient (``make_fused_chain_vjp``) at ``bench_pallas.py``'s
   two configurations, each a ``MultiModN`` of ``MIMICMLPEncoder``s
   (dropout 0) and one ``MLPDecoder(state, hidden, 2)`` on seeded data with
   ~30% of ``valid`` 0: shipped (widths 10, 1024, 768, 99, state 50, hidden
   (32, 32), batch 1024) and scaled (4 x 1024, state 256, hidden (1024,
   1024), batch 512). K1's forward within 1e-4 of the plain chain's
   (relative to the largest value); ``bench_pallas.py``'s loss and every
   gradient (layers, data, init row) through the VJP against autograd
   through the plain chain (loss 1e-5 relative, each gradient 1e-4 of its
   leaf's largest value); ten ``Adam(1e-3)`` steps through each, the
   parameters within 2 x 10 lr, K1 launched ``ChainSpec.launches`` times
   per step and K2 never; ``fwd_plain_ms``, ``fwd_k1_ms`` (and on 16-row
   tiles), ``train_plain_ms`` and ``train_k1_vjp_ms`` (CUDA events), each
   stage's device time, and the forward's and the training step's bounds;
20. K1 over the TPU kernel's whole domain through ``fused_forward`` (10%
   of the modality rows NaN): a 33-encoder featurewise chain (Stage B's
   ring) and the MIMIC widths at hidden (2048, 2048) (the layered
   variant) at B = 16; ``--chain-only`` runs the 1901-encoder featurewise
   chain at B = 1 and 64 and the wide model at B = 16 and 4096. Each
   within 1e-4 of the plain chain's largest value, with the plan's K1
   launches per call, as many as the same family at E = 4; K1's ms (CUDA
   events) and each stage's, the plain chain's ms and the bound, and the
   host-clock request ms of ``fused_forward`` and of ``predict_proba``
   on the same rows;
21. the earlier designs' times from PERF.md on a line of their own, the
   ``mnar``, ``transformer``, ``resume``, ``orders``, ``dropin``,
   ``experiments``, ``precision``, ``parallel``, ``parallel_encoders``,
   ``vjp`` and ``chain`` lines, one ``{"kernels": [...]}`` line of this
   run's numbers (launches summed over every path that ran the kernel, by
   phase in ``launches_by_phase``; K1's with ``titanic``, ``mnar``,
   ``resumed``, ``orders``, ``dropin``, ``experiments``, ``precision``,
   ``parallel``, ``vjp`` and ``chain`` blocks, K2's with ``resume``,
   ``orders``, ``experiments``, ``precision``, ``parallel`` and
   ``parallel_encoders`` blocks), the script's wall time, the card's line, and last the ``{"ok": true, ...}``
   line.

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
from multimodn_tpu_torch.core.tree import tree_leaves, tree_map
from multimodn_tpu_torch.data import ArrayLoader, PartitionDataset, Subset
from multimodn_tpu_torch.decoders import ClassDecoder, LogisticDecoder, \
    MLPDecoder
from multimodn_tpu_torch.encoders import MIMICMLPEncoder, MLPEncoder, \
    MLPFeatureEncoder
from multimodn_tpu_torch.ops import fused_adam as fa
from multimodn_tpu_torch.ops import fused_adam_fp32 as fa32
from multimodn_tpu_torch.ops.build import library_path
from multimodn_tpu_torch.ops.fused_adam import FUSED_ADAM
from multimodn_tpu_torch.ops.fused_adam_fp32 import FUSED_ADAM_FP32
from multimodn_tpu_torch.ops.fused_chain import FUSED_CHAIN, VARIANTS, \
    ChainSpec, fused_chain_forward, fused_chain_forward_ref, \
    make_fused_chain_forward, make_fused_chain_vjp, make_xla_chain_forward

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
# K3, the fp32 Adam update, on the leaves of the benchmark's image-model
# cell (mimic-cxr-resnet18): a ResNet-18 in the vd embedding's place among
# the MIMIC encoders, 133 leaves. Per element it reads p, g, m, v and writes
# p, m, v; float32 operations: moments 7, step 7.
CELL_WIDTHS = (10, None, 768, 99)          # None: the ResNet-18
CELL_LEAVES, CELL_PARAMS = 133, 11_260_898
ADAM_FP32_OPS_PER_ELEMENT = 14
ADAM_FP32_STEPS = 16                       # per-step wall and device times
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


def phase(title):
    """A phase's heading, with the script's seconds so far."""
    log(f"== {title} [{time.perf_counter() - START:.1f} s]")


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
        for kernel in ("stage_a_gemm", "chain_kernel", "segment_softmax",
                       "layered_kernel"):
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
        packed = spec.pack_data(list(data))
        got = fused_chain_forward(spec, params, data, valid, init_row)
        want = fused_chain_forward_ref(spec, params, data, valid, init_row)
        torch.cuda.synchronize()
        err = max_err(got, want)
        finite = all(torch.isfinite(t).all().item()
                     for t in [got[0], *got[1]])

        def kernel(large_tiles=True):
            FUSED_CHAIN.launch(spec, layers, packed, valid, init_row,
                               large_tiles=large_tiles)

        ms, launches = time_counted(kernel, FUSED_CHAIN)
        plain_ms = time_ms(lambda: fused_chain_forward_ref(
            spec, params, data, valid, init_row))
        bound_ms, bound_by, flops, nbytes = bound(spec, B)
        # Each Stage A launch's GEMM blocks and the copy blocks of the
        # state-path weights, as the wrapper launches them.
        stage_a_blocks = [level[2] for level in
                          spec.stage_a_plan(B, n_sm)[0]]
        copy_blocks = spec.copy_blocks
        variant = VARIANTS[FUSED_CHAIN.stage_b_config(
            spec, B, torch.device("cuda"))[0]]
        stages = stage_times(kernel) if B in (SERVING_BATCH, 65536) \
            else None
        records[B] = {"max_abs_err": err, "ms": ms, "launches": launches,
                      "stage_b": variant,
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
            f"blocks {copy_blocks}, Stage B {variant}"
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
        del data, packed, valid, got, want
    return records


def serving_requests(seed=0, widths=MIMIC_WIDTHS, batch=SERVING_BATCH):
    """8 requests of ``batch`` rows (16) over modalities of ``widths``; some
    rows have a NaN modality (whole row or a single entry) so the
    per-sample skip is exercised."""
    rng = np.random.default_rng(seed)
    requests = []
    for r in range(SERVING_REQUESTS):
        x = [rng.normal(size=(batch, w)).astype(np.float32)
             for w in widths]
        if r % 2 == 0:
            for e in range(len(x)):
                rows = rng.choice(batch, size=min(3, batch), replace=False)
                x[e][rows[:2]] = np.nan
                if len(rows) > 2:
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
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


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


def cell_model(device):
    """The benchmark's image-model cell's model: K3's 133 leaves."""
    from multimodn_tpu_torch.encoders import ResNet
    encoders = [ResNet(state_size=MIMIC_STATE) if w is None else
                MIMICMLPEncoder(MIMIC_STATE, w, (MIMIC_HIDDEN,) * 2,
                                dropout=0.0) for w in CELL_WIDTHS]
    decoders = [MLPDecoder(MIMIC_STATE, (MIMIC_HIDDEN,) * 2, 2)
                for _ in range(MIMIC_TARGETS)]
    return MultiModN(MIMIC_STATE, encoders, decoders, 1.0, 0.0, seed=0,
                     device=device)


def adam_fp32_bound(shapes, state_bytes):
    """(bound_ms, bound_by, bytes) of one K3 update: p, g and the moments
    read once, p and the moments written once."""
    n = sum(int(np.prod(s)) for s in shapes)
    nbytes = (12 + 4 * state_bytes) * n
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ADAM_FP32_OPS_PER_ELEMENT * n / PEAK_FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def k3_against_per_leaf(params, state_dtype, gated, gen, device, steps=3):
    """``steps`` ``Adam`` steps on copies of ``params``: through
    ``fused_apply`` (K3) and through ``update`` plus ``add_`` (the per-leaf
    PyTorch update), on the same gradients; gated, encoder 1 is off from
    the second step. Returns (mismatching elements of parameters and
    moments, K3 launches)."""
    opt = Adam(ADAM_LR, ADAM_BETAS, ADAM_EPS, state_dtype=state_dtype)
    p_k, p_u = tree_map(torch.clone, params), tree_map(torch.clone, params)
    s_k, s_u = opt.init(p_k), opt.init(p_u)
    on = [float(e != 1) for e in range(len(params["encoders"]))]
    before = FUSED_ADAM_FP32.launches
    for step in range(steps):
        g = tree_map(lambda p: adam_grad(tuple(p.shape), gen, device),
                     params)
        gates = torch.tensor(on, device=device) if gated and step else None
        s_k = opt.fused_apply(g, s_k, p_k, enc_gates=gates)
        upd, s_u = opt.update(g, s_u, p_u, enc_gates=gates)
        tree_map(lambda p, u: p.add_(u), p_u, upd)
    torch.cuda.synchronize()
    launches = FUSED_ADAM_FP32.launches - before
    bad = [(_bits(a) != _bits(b)).sum() for a, b in zip(
        tree_leaves([p_k, s_k["m"], s_k["v"]]),
        tree_leaves([p_u, s_u["m"], s_u["v"]]))]
    return int(torch.stack(bad).sum()), launches


def step_times(fn, steps=ADAM_FP32_STEPS):
    """Per call of ``fn``: the host clock's ms (synchronised at the end),
    then under ``torch.profiler`` the kernels' own device ms and the
    kernels launched."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.duration_ns() for e in kernels) / 1e6 / steps
    return {"wall_ms": wall_ms, "device_ms": device_ms or None,
            "kernels": len(kernels) / steps}


def time_adam_fp32(params, gen, device):
    """K3's time on one update of ``params``' leaves (CUDA events) beside
    its bound, with float32 and with bfloat16 moments, and one ``Adam``
    step's host and device time per step through ``fused_apply`` (K3 and
    the step counts) and through the per-leaf path (``update`` plus
    ``add_``)."""
    b1, b2 = ADAM_BETAS
    grads = tree_map(lambda p: adam_grad(tuple(p.shape), gen, device),
                     params)
    shapes = tuple(tuple(t.shape) for t in tree_leaves(params))
    out = {}
    for name, state_dtype, state_bytes in (("fp32", None, 4),
                                           ("bf16", torch.bfloat16, 2)):
        opt = Adam(ADAM_LR, ADAM_BETAS, ADAM_EPS, state_dtype=state_dtype)
        p = tree_map(torch.clone, params)
        state = opt.fused_apply(grads, opt.init(p), p)
        c12 = torch.tensor([1 - b1 ** 2, 1 - b2 ** 2], device=device)
        leaves = [(*t, c12, None) for t in zip(
            tree_leaves(p), tree_leaves(grads), tree_leaves(state["m"]),
            tree_leaves(state["v"]))]
        state_type = fa32.check_leaves(leaves, shapes)

        def kernel():
            FUSED_ADAM_FP32.launch(leaves, shapes, state_type, lr=ADAM_LR,
                                   b1=b1, b2=b2, eps=ADAM_EPS)

        ms, launches = time_counted(kernel, FUSED_ADAM_FP32)
        bound_ms, bound_by, nbytes = adam_fp32_bound(shapes, state_bytes)
        r = {"ms": ms, "launches": launches, "bound_ms": bound_ms,
             "bound_by": bound_by, "bytes": nbytes,
             "share_of_bound": bound_ms / ms,
             "fused_apply": step_times(
                 lambda: opt.fused_apply(grads, state, p))}
        if name == "fp32":
            u = tree_map(torch.clone, params)
            s_u = opt.init(u)

            def per_leaf():
                upd, _ = opt.update(grads, s_u, u)
                tree_map(lambda a, b: a.add_(b), u, upd)

            r["per_leaf"] = step_times(per_leaf)
        out[name] = r
    return out


def check_adam_fp32(device, gen):
    """Phase 5's K3 part: ``Adam`` through K3 against the per-leaf PyTorch
    update on the image-model cell's 133 leaves, bit for bit over 3 steps,
    gated and not, float32 and bfloat16 moments, one launch a step; then
    K3's time beside its bound and the per-leaf path's."""
    params = cell_model(device).params
    shapes = [tuple(t.shape) for t in tree_leaves(params)]
    n = sum(int(np.prod(s)) for s in shapes)
    if (len(shapes), n) != (CELL_LEAVES, CELL_PARAMS):
        raise AssertionError(f"the cell's model has {len(shapes)} leaves "
                             f"of {n} parameters")
    per_step = fa32.launches_per_update(shapes)
    result = {"leaves": len(shapes), "parameters": n,
              "launches_per_step": per_step}
    for name, state_dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        for gated in (False, True):
            bad, launches = k3_against_per_leaf(params, state_dtype, gated,
                                                gen, device)
            what = f"{name} moments, {'gated' if gated else 'ungated'}"
            log(f"  K3 against the per-leaf update, {what}, 3 steps: "
                f"{bad} mismatching elements, {launches} launches")
            result[f"{name}_{'gated' if gated else 'ungated'}"] = {
                "mismatches": bad, "launches": launches}
            if bad or launches != 3 * per_step:
                raise AssertionError(
                    f"K3 on the cell's leaves ({what}): {bad} mismatching "
                    f"elements, {launches} launches for 3 steps of "
                    f"{per_step}")
    result["times"] = time_adam_fp32(params, gen, device)
    for name, r in result["times"].items():
        log(f"  K3, {name} moments: {r['ms']:.4f} ms in {r['launches']:g} "
            f"launches, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{r['bytes']:.4g} B), {r['share_of_bound']:.2%} of bound; "
            f"fused_apply {json.dumps(r['fused_apply'])}"
            + (f"; per-leaf update {json.dumps(r['per_leaf'])}"
               if "per_leaf" in r else ""))
    return result


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
    FUSED_ADAM.launches = FUSED_ADAM_FP32.launches = 0
    t0 = time.perf_counter()
    best = model.fit_best(train_loader, optimizer, "cross_entropy",
                          epochs=TRAIN_EPOCHS, val_loader=val_loader,
                          history=history)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches, k3_launches = FUSED_ADAM.launches, FUSED_ADAM_FP32.launches
    t0 = time.perf_counter()
    model.train_epoch(train_loader, optimizer, "cross_entropy")
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    results = model.test(val_loader, "cross_entropy")
    losses = [float(np.mean(g)) for g in history.loss["train"]]
    steps = best["epochs_ran"] * train_loader.n_batches
    return {"launches": launches, "k3_launches": k3_launches,
            "steps": steps, "losses": losses,
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
    r = runs["Adam"]
    per_step = fa32.launches_per_update(shapes)
    if (r["launches"], r["k3_launches"]) != (0, per_step * r["steps"]):
        raise AssertionError(
            f"Adam launched K2 {r['launches']} and K3 {r['k3_launches']} "
            f"times for {r['steps']} steps of {per_step} K3 launches")
    log(f"  Adam: K3 launches {r['k3_launches']} = {per_step} per step x "
        f"{r['steps']} steps")
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


# Phase 8: the published-protocol runner (pipelines/mimic/all_protocols.py,
# the port of nips/run_all_protocols.py), its four stages cut in the main
# call; --all-protocols runs it at the published scale, or at --patients,
# --epochs, --nfold and --stages.
PROTOCOL_PATIENTS, PROTOCOL_EPOCHS, PROTOCOL_FOLDS = 120, 2, 2
FULL_PATIENTS, FULL_EPOCHS, FULL_FOLDS = 300, 100, 5
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


def parse_check(parses, read_numeric, table_io):
    """Every cache file a pipeline parsed, read again: the native reader
    must take it, and the Python parse must give the same bits (NaN where
    NaN). The seconds of the pipeline's first native parse of each file
    beside the Python parse's, timed here after the pipeline."""
    from multimodn_tpu_torch.data import native
    first = {}
    for sec, _key, _rows, path in parses:
        first.setdefault(path, sec)
    refused, differ, python_s = 0, 0, 0.0
    for path in first:
        refused += native.read_csv_f64(path) is None
        values = read_numeric(path)[1]
        t0 = time.perf_counter()
        py = table_io._parse_numeric(path)[0].T
        python_s += time.perf_counter() - t0
        nan = np.isnan(values)
        differ += not (np.array_equal(nan, np.isnan(py)) and np.array_equal(
            values[~nan].view(np.uint64), py[~nan].view(np.uint64)))
    return {"cache_files": len(first), "files_python_parse": refused,
            "files_not_bit_equal": differ,
            "native_parse_s": sum(first.values()),
            "python_parse_s": python_s}


def auroc_by_target(path, table_io):
    """Mean, fold spread (sample std) and count of the test AUROC per model
    and target of a pipeline's results CSV."""
    rows = table_io.read_csv(path)
    out = {}
    for model in ("modn", "haim"):
        for target in sorted(set(rows["target"].tolist())):
            auc = rows["auc"][(rows["model"] == model)
                              & (rows["target"] == target)]
            out[f"{model} {target}"] = {
                "mean": float(np.mean(auc)),
                "spread": float(np.std(auc, ddof=1)) if len(auc) > 1
                else None, "folds": int(len(auc))}
    return out


def beside_published(mine, published):
    """Each (model, target) beside the JAX package's committed TPU rows:
    their means' gap in fold spreads (the larger of the two)."""
    out = {}
    for key, r in mine.items():
        theirs = published.get(key)
        spreads = [x for x in (r["spread"], theirs and theirs["spread"])
                   if x]
        gap = None if not (theirs and spreads) else \
            abs(r["mean"] - theirs["mean"]) / max(spreads)
        out[key] = {"port": r, "jax_tpu": theirs, "gap_in_spreads": gap}
    return out


def run_all_protocols(device, patients, epochs, nfold, stages=(1, 2, 3, 4),
                      keep=None):
    """Phase 8: the published-protocol runner on the card at ``patients``,
    ``epochs`` and ``nfold``, in a temporary storage directory; each stage
    timed (data and cache, MultiModN and HAIM folds, steps/s, the MNAR
    levels), its models on the card, its cache files read natively and
    bit-equal to the Python parse, no kernel launched, its CSVs checked
    and their AUROCs set beside the JAX package's committed rows in
    ``nips/results/``. ``keep``: a directory to copy the CSVs to."""
    from multimodn_tpu_torch.baselines.haim import HAIM
    from multimodn_tpu_torch.data import mimic as mimic_data
    from multimodn_tpu_torch.data import table as table_io
    from multimodn_tpu_torch.pipelines.mimic import all_protocols as runner
    from multimodn_tpu_torch.pipelines.mimic import common, \
        mimic_multi_task_pipeline, mimic_single_task_pipeline
    from multimodn_tpu_torch.pipelines.mimic import mnar_protocol as proto

    if foreign_modules():
        raise AssertionError(f"loaded before phase 8: {foreign_modules()}")
    models, records, level_s = [], {}, []
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
    # Each parse of a cache file: its seconds, and whether the per-file
    # parse memo of data/table.py served it (the same array came back).
    parses, read_numeric = [], mimic_data.read_numeric_csv

    def timed_read(path):
        t0 = time.perf_counter()
        out = read_numeric(path)
        parses.append((time.perf_counter() - t0, id(out[1]),
                       out[1].shape[1], path))
        return out

    level_main = proto.mnar_pipeline.main

    def timed_level(*args, **kwargs):
        t0 = time.perf_counter()
        out = level_main(*args, **kwargs)
        torch.cuda.synchronize()
        level_s.append(time.perf_counter() - t0)
        return out

    def staged(owner, name):
        """Wrap a stage's main: each stage starts as in a process of its
        own (no parse kept), with the launch counters at 0."""
        fn = owner.main

        def run(*args, **kwargs):
            stage = name or runner.STAGE_NAMES[
                3 if kwargs["nan_skip"] == "batch" else 4]
            table_io._NUMERIC_CACHE.clear()
            del parses[:], level_s[:]
            torch.cuda.synchronize()
            FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
            n_models = len(models)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            seconds, steps = clock.take()
            first = {}
            for sec, key, _, _ in parses:
                first.setdefault(key, sec)
            records[stage] = {
                "wall_s": wall,
                "data_and_cache_s": seconds.get("data", 0.0),
                "modn_folds_s": seconds.get("modn", 0.0),
                "haim_folds_s": seconds.get("haim", 0.0),
                "other_s": wall - sum(seconds.values()),
                **fold_rates(seconds, steps),
                "models": models[n_models:],
                "launches": (FUSED_CHAIN.launches, FUSED_ADAM.launches),
                "parses": len(parses), "parse_misses": len(first),
                "parse_miss_s": sum(first.values()),
                "parse_hit_s": sum(p[0] for p in parses)
                - sum(first.values()),
                "cache_rows": max(p[2] for p in parses),
                "native_read": parse_check(parses, read_numeric, table_io),
                "level_s": dict(zip([str(mp) for mp in proto.MISS_PERCS],
                                    level_s))}
            return out

        owner.main = run
        return fn

    patched = [(m, staged(m, n)) for m, n in (
        (mimic_single_task_pipeline, runner.STAGE_NAMES[1]),
        (mimic_multi_task_pipeline, runner.STAGE_NAMES[2]), (proto, None))]

    def undo_patches():
        clock.restore()
        common.build_modn, common.HAIM = build, HAIM
        mimic_data.read_numeric_csv = read_numeric
        proto.mnar_pipeline.main = level_main
        for owner, fn in patched:
            owner.main = fn

    common.build_modn, common.HAIM = recording_build, RecordingHAIM
    mimic_data.read_numeric_csv = timed_read
    proto.mnar_pipeline.main = timed_level
    published = os.path.join(ROOT, "nips", "results")
    levels = proto.MISS_PERCS
    with contextlib.ExitStack() as stack:
        stack.callback(undo_patches)
        work = stack.enter_context(scratch_storage("chip_smoke_protocol_"))
        t0 = time.perf_counter()
        walls = runner.main(patients, epochs, nfold, device=device,
                            stages=stages)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        results = os.path.join(work, "store", "nips", "results")
        files = {1: runner.SHARED[0], 2: runner.SHARED[1],
                 3: runner.SHARED[2], 4: runner.SAMPLE_COPY}
        for stage in sorted(stages):
            name = runner.STAGE_NAMES[stage]
            r = records.pop(name)
            stage_models = r.pop("models")
            off_card = [type(m).__name__ for m in stage_models
                        if not all(t.is_cuda for t in tree_leaves(m.params))]
            if off_card or not stage_models:
                raise AssertionError(f"{name}: parameters off the card in "
                                     f"{off_card}")
            if r["launches"] != (0, 0):
                raise AssertionError(f"{name}: the fused kernels launched "
                                     f"{r['launches']} times on the "
                                     f"protocol path, which runs neither")
            if r["native_read"]["files_python_parse"] or \
                    r["native_read"]["files_not_bit_equal"]:
                raise AssertionError(f"{name}: the cache files' native read "
                                     f"{r['native_read']}")
            with open(os.path.join(results, files[stage]), newline="") as f:
                table = list(csv.DictReader(f))
            # 2 targets x nfold folds x 2 models, each MNAR model tested
            # once at 0% and twice (clean, flipped) at each other level.
            tests = 1 if stage < 3 else 1 + 2 * (len(levels) - 1)
            aucs = [float(row["auc"]) for row in table]
            if len(table) != 4 * nfold * tests:
                raise AssertionError(f"{name}: {len(table)} CSV rows, want "
                                     f"{4 * nfold * tests}")
            if not all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in aucs):
                raise AssertionError(f"{name}: AUROC outside [0, 1]")
            r.update({"patients": patients, "epochs": epochs, "folds": nfold,
                      "rows": len(table), "auc_min": min(aucs),
                      "auc_max": max(aucs), "stage_wall_s": walls[name]})
            if stage < 3:
                r["auroc"] = beside_published(
                    auroc_by_target(os.path.join(results, files[stage]),
                                    table_io),
                    auroc_by_target(os.path.join(published, files[stage]),
                                    table_io))
            else:
                nan_skip = "batch" if stage == 3 else "sample"
                tag = proto.variant_tag(nan_skip, 0.0, patients, epochs,
                                        nfold)
                rows = table_io.read_csv(os.path.join(
                    results, f"mnar_protocol_rows_{tag}.csv"))
                for model in ("modn", "haim"):
                    n = int((rows["model"] == model).sum())
                    if n != 2 * nfold * tests:
                        raise AssertionError(f"{tag}: {n} {model} rows, "
                                             f"want {2 * nfold * tests}")
                summary = table_io.read_csv(os.path.join(
                    results, f"mnar_robustness_summary_{tag}.csv"))
                n_groups = 2 * (2 * len(levels) - 1)
                if len(summary["mean"]) != n_groups or list(
                        summary["count"]) != [2 * nfold] * n_groups:
                    raise AssertionError(f"{tag}: summary {summary}")
                jax = table_io.read_csv(os.path.join(
                    published, f"mnar_robustness_summary_{nan_skip}.csv"))
                r["auroc"] = {"port": flipped_table(summary, levels),
                              "jax_tpu": flipped_table(jax, levels),
                              "port_std": flipped_table(
                                  dict(summary, mean=summary["std"]), levels),
                              "jax_tpu_std": flipped_table(
                                  dict(jax, mean=jax["std"]), levels)}
            records[name] = r
            log(f"  {name}: {json.dumps(r)}")
        if keep:
            os.makedirs(keep, exist_ok=True)
            for f in os.listdir(results):
                shutil.copy(os.path.join(results, f), keep)
    if foreign_modules():
        raise AssertionError(f"loaded by phase 8: {foreign_modules()}")
    log(f"  pandas, scikit-learn, JAX and the JAX package not loaded; "
        f"MultiModN and HAIM parameters on {device}")
    records["total_s"] = total
    return records


# Phase 9: the six Titanic pipelines at the reference's smoke depth
# (pipelines/test_all_pipelines.sh:13), the quick-start at its published
# depth, and the trained MLP-family models served through K1.
TITANIC_PIPELINES = ("titanic_mlp", "titanic_partitioned",
                     "titanic_featurewise", "titanic_missingness",
                     "titanic_lstm", "titanic_rnn")
# The quick-start's published depth is 300 epochs; 100 keep the script
# inside its time limit (the loss has fallen well before).
TITANIC_EPOCHS, QUICKSTART_EPOCHS = 5, 100
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


def run_quickstart(device, work):
    """The port's quick-start (``examples/quickstart.py``'s ``main``) for
    ``QUICKSTART_EPOCHS`` of ``fit`` with validation, its artifact in
    ``work``: the training loss falls, the validation AUROC is finite, the
    session's probabilities are the model's own and the artifact's reload
    answers as the model does."""
    from multimodn_tpu_torch.examples import quickstart
    clock = PhaseClock()
    clock.wrap(MultiModN, "fit", "fit", steps=lambda out, self, tr, *a,
               **k: k["epochs"] * tr.n_batches)
    try:
        out = quickstart.main(device, workdir=work,
                              epochs=QUICKSTART_EPOCHS)
    finally:
        clock.restore()
    seconds, steps = clock.take()
    model, history = out["model"], out["history"]
    losses = mean_losses(history, "train")
    r = {"epochs": QUICKSTART_EPOCHS, "fit_s": seconds["fit"],
         "steps": steps["fit"], "steps_per_s": steps["fit"] / seconds["fit"],
         "first_train_loss": losses[0], "last_train_loss": losses[-1],
         "last_val_loss": mean_losses(history, "val")[-1],
         "val_auroc": out["val"]["auroc"], "val_f1": out["val"]["f1"],
         "val_accuracy": out["val"]["accuracy"],
         "session_prior": out["prior"].tolist(),
         "session_after": out["after"].tolist(),
         "artifact_round_trip": out["round_trip"]}
    log(f"  quick-start: {json.dumps(r)}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"quick-start: the training loss did not fall "
                             f"({losses[0]} -> {losses[-1]})")
    if not np.isfinite(out["val"]["auroc"]):
        raise AssertionError("quick-start: validation AUROC is not finite")
    probs = model.predict_proba([out["rows"]])[0]
    if not (out["round_trip"] and np.allclose(out["prior"], probs[0, :, 1])
            and np.allclose(out["after"], probs[1, :, 1])):
        raise AssertionError("quick-start: the session or the artifact "
                             "answers otherwise than the model")
    if not all(t.device.type == device.type
               for t in tree_leaves(model.params)):
        raise AssertionError(f"quick-start: parameters off {device}")
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
    packed, valid = model._packed_request(requests[0], spec)
    init_row = model.params["init_state"]["value"][0].contiguous()
    layers = spec.layer_params(model.params)
    ms, per_call = time_counted(lambda: FUSED_CHAIN.launch(
        spec, layers, packed, valid, init_row), FUSED_CHAIN)
    plain_ms = time_ms(lambda: fused_chain_forward_ref(
        spec, model.params, packed, valid, init_row))
    bound_ms, bound_by, flops, nbytes = bound(spec, packed.shape[0])
    if per_call != spec.launches:
        raise AssertionError(f"{name}: {per_call} launches per timed call, "
                             f"the plan gives {spec.launches}")
    return {"pipeline": name, "requests": len(requests),
            "rows": sum(x[0].shape[0] for x in requests),
            "nan_cells": nan_cells, "launches": launches,
            "launches_per_request": spec.launches, "max_abs_err": err_chain,
            "session_max_abs_err": err_session, "batch": packed.shape[0],
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
        quick, trained["titanic_mlp"] = run_quickstart(device, work)
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


# Phase 10: a MIMIC model trained with the per-sample skip and the presence
# penalty on an MNAR-degraded fold, served through K1 (the MNAR protocol
# itself runs in phase 8's stages 3 and 4).
MNAR_PATIENTS, MNAR_EPOCHS = 120, 2
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
FEATUREWISE_EPOCHS, FEATUREWISE_MISSING = 1, 0.1
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


# Phase 15: the experiment surface and ahead-of-time serving at the MIMIC
# model's full width on phase 6's cohort: a 4-seed Adam8bit sweep (2 epochs,
# each seed held bit for bit against its own fit_best), a 2-fold k-fold with
# patience, seed 0's best model as a torch.export artifact served at three
# batch sizes against K1 and the plain chain, a profiling.trace of 8 steps,
# and the production-features example.
EXP_SEEDS, EXP_EPOCHS = (0, 1), 2
EXP_FOLDS, EXP_FOLD_EPOCHS, EXP_PATIENCE = 2, 3, 1
EXP_BATCHES = (1, 16, 32)
# The artifact runs the plain chain's aten ops on the card, so it agrees with
# the plain chain up to cuBLAS choosing other kernels for other shapes.
ARTIFACT_TOL = 1e-5


def exp_model(device):
    return lambda seed: mimic_model(device, seed=seed)


def exp_payloads(seen, n, label):
    """``n`` payloads of ``fit_best``'s keys, every value finite."""
    keys = {"epoch", "train_loss", "val_loss", "score"}
    if len(seen) != n or any(set(p) != keys for p in seen) or not all(
            np.isfinite(v) for p in seen for v in p.values()):
        raise AssertionError(f"{label}: on_epoch payloads {seen}")


def exp_sweep(device, train_set, val_set):
    """(1) the sweep on the main path, K2 counted; then each seed's own
    fit_best on a fresh loader (uncounted) against it, bit for bit."""
    from multimodn_tpu_torch.experiments import sweep_fit_best
    train = ArrayLoader(train_set, TRAIN_BATCH, shuffle=True, seed=0)
    val = ArrayLoader(val_set, TRAIN_BATCH)
    seen = []
    torch.cuda.synchronize()
    FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
    t0 = time.perf_counter()
    results = sweep_fit_best(exp_model(device), train, val,
                             Adam8bit(ADAM_LR), "cross_entropy",
                             epochs=EXP_EPOCHS, seeds=EXP_SEEDS,
                             on_epoch=seen.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2, k1 = FUSED_ADAM.launches, FUSED_CHAIN.launches
    steps = sum(r["epochs_ran"] for r in results) * train.n_batches
    per_step = fa.launches_per_update(
        [tuple(t.shape) for t in tree_leaves(results[0]["model"].params)])
    if k2 != per_step * steps or k1:
        raise AssertionError(f"sweep: K2 {k2} launches for {steps} steps of "
                             f"{per_step}, K1 {k1}")
    exp_payloads(seen, len(EXP_SEEDS) * EXP_EPOCHS, "sweep")
    mismatches = []
    for seed, r in zip(EXP_SEEDS, results):
        model = mimic_model(device, seed=seed)
        info = model.fit_best(
            ArrayLoader(train_set, TRAIN_BATCH, shuffle=True, seed=0),
            Adam8bit(ADAM_LR), "cross_entropy", epochs=EXP_EPOCHS,
            val_loader=ArrayLoader(val_set, TRAIN_BATCH))
        bad = bit_mismatches(r["model"], model)
        mismatches.append(bad)
        if bad or info["best_epoch"] != r["best_epoch"] or \
                not np.array_equal(info["scores"], r["scores"]):
            raise AssertionError(
                f"sweep seed {seed}: {bad} elements differ from its own "
                f"fit_best; best epoch {r['best_epoch']} against "
                f"{info['best_epoch']}")
    out = {"seeds": list(EXP_SEEDS), "epochs": EXP_EPOCHS, "steps": steps,
           "wall_s": wall, "steps_per_s": steps / wall, "k2_launches": k2,
           "k2_launches_per_step": k2 / steps, "payloads": len(seen),
           "best_epochs": [r["best_epoch"] for r in results],
           "best_scores": [r["best_score"] for r in results],
           "mismatching_elements_vs_fit_best": mismatches}
    log(f"  sweep_fit_best, Adam8bit: {json.dumps(out)}")
    return out, results


def exp_kfold(device, train_set, val_set):
    """(2) two folds of the cohort's training rows, patience 1."""
    from multimodn_tpu_torch.experiments import fold_history, kfold_fit_best
    half = len(train_set.indices) // EXP_FOLDS
    folds = [(ArrayLoader(Subset(train_set.dataset, train_set.indices[
        f * half:(f + 1) * half]), TRAIN_BATCH), ArrayLoader(
            val_set, TRAIN_BATCH)) for f in range(EXP_FOLDS)]
    seen = []
    torch.cuda.synchronize()
    FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
    t0 = time.perf_counter()
    results = kfold_fit_best(exp_model(device), folds, Adam8bit(ADAM_LR),
                             "cross_entropy", epochs=EXP_FOLD_EPOCHS,
                             patience=EXP_PATIENCE, on_epoch=seen.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2 = FUSED_ADAM.launches
    ran = [r["epochs_ran"] for r in results]
    steps = sum(n * f[0].n_batches for n, f in zip(ran, folds))
    if k2 != steps or FUSED_CHAIN.launches:
        raise AssertionError(f"k-fold: K2 {k2} launches for {steps} steps")
    exp_payloads(seen, sum(ran), "k-fold")
    if [p["epoch"] for p in seen] != [e for n in ran for e in range(n)]:
        raise AssertionError(f"k-fold payload order {seen}")
    history = fold_history(results[0], [f"t{d}" for d in
                                        range(MIMIC_TARGETS)])
    if len(history.loss["val"]) != ran[0]:
        raise AssertionError("fold_history rows")
    out = {"folds": EXP_FOLDS, "epochs": EXP_FOLD_EPOCHS,
           "patience": EXP_PATIENCE, "epochs_ran": ran, "steps": steps,
           "wall_s": wall, "steps_per_s": steps / wall, "k2_launches": k2,
           "payloads": len(seen)}
    log(f"  kfold_fit_best, Adam8bit, patience {EXP_PATIENCE}: "
        f"{json.dumps(out)}")
    return out


def plain_outputs(model, x, device):
    """The plain chain with the per-sample skip, every decoder on every
    state row."""
    data = tuple(torch.as_tensor(m, device=device) for m in x)
    states = forward_chain(
        model.encoders, model.init_state, model.params, data,
        torch.ones(x[0].shape[0], device=device),
        order=default_order(len(model.encoders)), nan_skip="sample")[0]
    return [dec.apply(model.params["decoders"][d], states)
            for d, dec in enumerate(model.decoders)]


def exp_artifact(device, model, work):
    """(3) seed 0's best model through export_compiled (traced on the CPU)
    and load_compiled onto the card; requests of 1, 16 and 32 rows with NaN
    cells against K1's fused_forward (launches counted) and the plain chain;
    warm p50 per request of 16, the artifact's and K1's, in turns."""
    from multimodn_tpu_torch import export_compiled, load_compiled
    t0 = time.perf_counter()
    path = export_compiled(model, os.path.join(work, "model.pt2"))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = load_compiled(path, device="cuda")
    load_s = time.perf_counter() - t0
    if load_compiled(path)(*serving_requests(seed=16)[0])[0].device.type \
            != "cuda":
        raise AssertionError("load_compiled() did not default to the card")
    requests = [x for b in EXP_BATCHES for x in serving_requests(
        seed=150 + b, batch=b)[:2]]
    torch.cuda.synchronize()
    FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
    err_k1 = err_plain = 0.0
    for x in requests:
        got = run(*x)
        _states, k1 = model.fused_forward(x)
        plain = plain_outputs(model, x, device)
        for g in got:
            if g.device.type != "cuda" or not torch.isfinite(g).all():
                raise AssertionError("artifact answer not finite on the card")
        err_k1 = max(err_k1, max_err(list(got), k1))
        err_plain = max(err_plain, max_err(list(got), plain))
    torch.cuda.synchronize()
    launches = FUSED_CHAIN.launches
    per_request = ChainSpec(model.encoders, model.decoders,
                            model.state_size).launches
    if launches != per_request * len(requests) or FUSED_ADAM.launches:
        raise AssertionError(f"artifact check: K1 {launches} launches for "
                             f"{len(requests)} requests")
    if not (err_k1 <= TOL and err_plain <= ARTIFACT_TOL):
        raise AssertionError(f"artifact against K1 {err_k1:.3e}, against "
                             f"the plain chain {err_plain:.3e}")
    warm = serving_requests(seed=17)
    times = {"artifact": [], "k1": []}
    for rep in range(4):
        for x in warm:
            order = ("artifact", "k1") if rep % 2 == 0 else ("k1", "artifact")
            for name in order:
                t0 = time.perf_counter()
                run(*x) if name == "artifact" else model.fused_forward(x)
                torch.cuda.synchronize()
                times[name].append(1e3 * (time.perf_counter() - t0))
    out = {"batches": list(EXP_BATCHES), "requests": len(requests),
           "k1_launches": launches, "launches_per_request": per_request,
           "max_abs_err_vs_k1": err_k1, "tolerance_vs_k1": TOL,
           "max_abs_err_vs_plain": err_plain,
           "tolerance_vs_plain": ARTIFACT_TOL,
           "artifact_bytes": os.path.getsize(path), "export_s": export_s,
           "load_s": load_s, "warm_requests": len(times["k1"]),
           "batch": SERVING_BATCH,
           "artifact_request_ms_p50": float(np.percentile(
               times["artifact"], 50)),
           "k1_request_ms_p50": float(np.percentile(times["k1"], 50)),
           "artifact_request_ms_p90": float(np.percentile(
               times["artifact"], 90)),
           "k1_request_ms_p90": float(np.percentile(times["k1"], 90))}
    log(f"  export_compiled -> load_compiled on the card: {json.dumps(out)}")
    return out


def exp_trace(device, train_set, work, steps=8):
    """(4) utils.profiling.trace around 8 Adam8bit steps of the MIMIC
    model, each epoch under annotate(); the trace must name the region."""
    from multimodn_tpu_torch.utils.profiling import EpochTimer, annotate, \
        trace
    loader = ArrayLoader(Subset(train_set.dataset,
                                train_set.indices[:steps * TRAIN_BATCH]),
                         TRAIN_BATCH)
    steps = loader.n_batches
    model, optimizer = mimic_model(device), Adam8bit(ADAM_LR)
    model.train_epoch(loader, optimizer, "cross_entropy")   # warm-up
    logdir = os.path.join(work, "trace")
    timer = EpochTimer(sync_tree=model.params)
    torch.cuda.synchronize()
    FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
    with trace(logdir):
        with timer.epoch(), annotate("chip_smoke_train_epoch"):
            model.train_epoch(loader, optimizer, "cross_entropy")
    k2 = FUSED_ADAM.launches
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    device_ms = sum(e.get("dur", 0) for e in kernels) / 1e3
    if "chip_smoke_train_epoch" not in names or k2 != steps:
        raise AssertionError(f"trace: annotation present "
                             f"{'chip_smoke_train_epoch' in names}, K2 {k2}")
    out = {"steps": steps, "k2_launches": k2, "epoch_ms": 1e3 * timer.last_s,
           "trace_events": len(events), "kernels_per_step":
           len(kernels) / steps, "device_ms_per_step": device_ms / steps,
           "device_busy_share": device_ms / (1e3 * timer.last_s)}
    log(f"  profiling.trace of {steps} steps: {json.dumps(out)}")
    return out


def exp_example(device):
    """(5) the port of examples/production_features.py on the card."""
    from multimodn_tpu_torch.examples import production_features
    t0 = time.perf_counter()
    out = production_features.main(device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    served = out["served"]
    if not (np.isfinite(out["resumable"]["best_score"])
            and out["resumable"]["epochs_run"] == 20
            and all(p.device.type == "cuda" and p.shape == (3, b, 2)
                    and torch.isfinite(p).all() for b, p in served.items())
            and len(out["kfold"]) == 2):
        raise AssertionError("production_features: unexpected results")
    r = {"wall_s": wall, "best_score": out["resumable"]["best_score"],
         "kfold_best_scores": [f["best_score"] for f in out["kfold"]]}
    log(f"  production_features example: {json.dumps(r)}")
    return r


def run_experiments(device):
    """Phase 15."""
    if foreign_modules():
        raise AssertionError(f"loaded before phase 15: {foreign_modules()}")
    _ds, train_set, val_set = mimic_training_loaders()
    work = tempfile.mkdtemp(prefix="chip_smoke_experiments_")
    try:
        sweep, results = exp_sweep(device, train_set, val_set)
        kfold = exp_kfold(device, train_set, val_set)
        artifact = exp_artifact(device, results[0]["model"], work)
        profiled = exp_trace(device, train_set, work)
        example = exp_example(device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if foreign_modules():
        raise AssertionError(f"loaded by phase 15: {foreign_modules()}")
    return {"sweep": sweep, "kfold": kfold, "artifact": artifact,
            "trace": profiled, "example": example}


# Phase 16: mixed precision and the ResNet-18 image encoder. (a) The MIMIC
# model at full width with compute_dtype='bfloat16' trained by fit_best on
# phase 6's cohort through Adam8bit (K2 once per step) beside the same run
# in fp32, one step on the card against the CPU, and the model exported,
# loaded (keeping the dtype) and serving 8 requests through K1 in fp32;
# (b) Adam(state_dtype=torch.bfloat16) on that model; (c) the transformer
# step in bf16 beside fp32 (utils.profiling.trace); (d) a ResNet-18 over
# 224 x 224 x 3 images with 30% of them NaN beside a MIMICMLPEncoder, trained
# in fp32 and in bf16 through Adam8bit, K2 held bit for bit on every ResNet
# leaf, the masked BatchNorm, update_batch_stats then eval-mode predict, and
# one step on the card against the CPU.
PRECISION_EPOCHS, PRECISION_DTYPE = 2, "bfloat16"
# The JAX package's own bound between a bf16 and an fp32 training run
# (tests/test_mixed_precision.py:37-39).
BF16_LOSS_RTOL, BF16_LOSS_ATOL = 0.05, 0.02
# One Adam8bit step from the same weights on the card and the CPU. The two
# sum products in other orders (in bf16, both accumulate in fp32 and round
# to bf16, so an activation may take the neighbouring bf16 number), so a
# gradient near 0 may take opposite signs. The first step moves a
# parameter by lr * m_hat / sqrt(v_hat), which is lr exactly in fp32; the
# fp8 codes round m by up to 2**-4 and v by up to 2**-4 (sqrt: 2**-5), so
# by up to 1.1 lr here, and two opposite moves differ by up to 2.2 lr.
ONE_STEP_TOL = 2.2 * ADAM_LR
IMAGE_SIZE, IMAGE_ROWS, IMAGE_VAL_ROWS, IMAGE_BATCH, IMAGE_EPOCHS = \
    224, 256, 64, 32, 2
IMAGE_MISSING, IMAGE_CPU_ROWS, IMAGE_TRACE_BATCHES = 0.3, 8, 4
IMAGE_FEATURES = MIMIC_WIDTHS[1]


def precision_fit(device, dtype, train_set, val_set, epochs, make_optimizer,
                  count=False):
    """``fit_best`` of the MIMIC model in ``dtype``: the model, the
    history's mean training losses, K2's launches over the call (counted
    from 0 when ``count``), its steps and wall time."""
    model = mimic_model(device, compute_dtype=dtype)
    train = ArrayLoader(train_set, TRAIN_BATCH, shuffle=True, seed=0)
    val = ArrayLoader(val_set, TRAIN_BATCH)
    history = MultiModNHistory([f"t{d}" for d in range(MIMIC_TARGETS)])
    torch.cuda.synchronize()
    if count:
        FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
    before = FUSED_ADAM.launches
    t0 = time.perf_counter()
    best = model.fit_best(train, make_optimizer(), "cross_entropy",
                          epochs=epochs, val_loader=val, history=history)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(np.mean(g)) for g in history.loss["train"]]
    steps = best["epochs_ran"] * train.n_batches
    return model, {"losses": losses, "k2_launches":
                   FUSED_ADAM.launches - before, "steps": steps,
                   "wall_s": wall, "steps_per_s": steps / wall,
                   "best_epoch": best["best_epoch"],
                   "best_score": best["best_score"]}


def masters_fp32(model, label):
    if not all(t.dtype == torch.float32 for t in tree_leaves(model.params)):
        raise AssertionError(f"{label}: a master parameter is not fp32")


def one_step_against_cpu(make_model, dataset, optimizer, tol, label,
                         device, batch):
    """One step of ``optimizer`` from the same weights on the same batch on
    the card and the CPU: the largest parameter difference, held to
    ``tol``."""
    gpu, cpu = make_model(device), make_model("cpu")
    cpu.load_state_dict(gpu.state_dict())
    for m in (gpu, cpu):
        m.train_epoch(ArrayLoader(dataset, batch), optimizer(),
                      "cross_entropy")
    torch.cuda.synchronize()
    err = param_err(gpu, cpu)
    log(f"  card vs CPU, {label}, one step: max abs param diff {err:.3e} "
        f"(tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{label}: the card and the CPU disagree")
    return err


def precision_bf16_mimic(device, work):
    """(a) and (b)."""
    _ds, train_set, val_set = mimic_training_loaders()
    fp32, fp32_run = precision_fit(device, None, train_set, val_set,
                                   PRECISION_EPOCHS, lambda: Adam8bit(ADAM_LR))
    model, run = precision_fit(device, PRECISION_DTYPE, train_set, val_set,
                               PRECISION_EPOCHS, lambda: Adam8bit(ADAM_LR),
                               count=True)
    masters_fp32(model, "bf16 MIMIC")
    per_step = fa.launches_per_update(
        [tuple(t.shape) for t in tree_leaves(model.params)])
    if run["k2_launches"] != per_step * run["steps"] or FUSED_CHAIN.launches:
        raise AssertionError(f"bf16 MIMIC: K2 {run['k2_launches']} launches "
                             f"for {run['steps']} steps of {per_step}")
    last, ref = run["losses"][-1], fp32_run["losses"][-1]
    if not (np.isfinite(run["losses"]).all() and np.isclose(
            last, ref, rtol=BF16_LOSS_RTOL, atol=BF16_LOSS_ATOL)):
        raise AssertionError(f"bf16 MIMIC: final training loss {last} "
                             f"against fp32 {ref}")
    _d, small, _v = mimic_training_loaders()
    subset = Subset(small.dataset, small.indices[:TRAIN_BATCH])
    device_err = one_step_against_cpu(
        lambda d: mimic_model(d, seed=1, dropout=0.0,
                              compute_dtype=PRECISION_DTYPE),
        subset, lambda: Adam8bit(ADAM_LR), ONE_STEP_TOL,
        "bf16 MIMIC, Adam8bit", device, TRAIN_BATCH)
    loaded = export_and_load(model, os.path.join(work, "bf16"), device,
                             "bf16 MIMIC")
    if loaded.compute_dtype != PRECISION_DTYPE:
        raise AssertionError(f"load_model gave compute_dtype "
                             f"{loaded.compute_dtype!r}")
    served = serve_trained("bf16 MIMIC", loaded, serving_requests(seed=160),
                           device)
    out = {"dtype": PRECISION_DTYPE, "epochs": PRECISION_EPOCHS,
           "batch": TRAIN_BATCH, "bf16": run, "fp32": fp32_run,
           "loss_rtol": BF16_LOSS_RTOL, "loss_atol": BF16_LOSS_ATOL,
           "k2_launches_per_step": per_step,
           "device_vs_cpu_max_abs_err": device_err,
           "device_vs_cpu_tolerance": ONE_STEP_TOL}
    log(f"  bf16 MIMIC fit_best, Adam8bit: {json.dumps(out)}")
    log(f"  bf16 MIMIC served through K1 in fp32: {json.dumps(served)}")

    # (b) bf16 moments, beside fp32 moments.
    _m, adam_fp32 = precision_fit(device, PRECISION_DTYPE, train_set,
                                  val_set, 1, lambda: Adam(ADAM_LR))
    adam_model, adam_run = precision_fit(
        device, PRECISION_DTYPE, train_set, val_set, 1,
        lambda: Adam(ADAM_LR, state_dtype=torch.bfloat16))
    moments = [t.dtype for k in ("m", "v")
               for t in tree_leaves(adam_model.opt_state[k])]
    if set(moments) != {torch.bfloat16} or \
            not np.isfinite(adam_run["losses"]).all():
        raise AssertionError(f"Adam(state_dtype=bf16): moments {set(moments)}"
                             f", losses {adam_run['losses']}")
    masters_fp32(adam_model, "Adam(state_dtype=bf16)")
    adam_run["moment_dtype"] = "bfloat16"
    adam_run["fp32_moments_steps_per_s"] = adam_fp32["steps_per_s"]
    log(f"  Adam(state_dtype=bfloat16), bf16 MIMIC: {json.dumps(adam_run)}")
    return out, served, adam_run


def trace_steps(model, loader, optimizer, work, label):
    """A warm-up epoch, a timed epoch (steps/s), then one epoch under
    ``utils.profiling.trace``: kernels per step, device ms per step and the
    busy share, read from the trace's kernel events."""
    from multimodn_tpu_torch.utils.profiling import trace
    model.train_epoch(loader, optimizer, "cross_entropy")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.train_epoch(loader, optimizer, "cross_entropy")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    logdir = os.path.join(work, label.replace(" ", "_"))
    with trace(logdir):
        t0 = time.perf_counter()
        model.train_epoch(loader, optimizer, "cross_entropy")
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    steps = loader.n_batches
    device_ms = sum(e.get("dur", 0) for e in kernels) / 1e3
    ops = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            ms, n = ops.get(e["name"], (0.0, 0))
            ops[e["name"]] = (ms + e.get("dur", 0) / 1e3, n + 1)
    r = {"steps": steps, "steps_per_s": steps / wall,
         "step_ms": 1e3 * wall / steps,
         "kernels_per_step": len(kernels) / steps,
         "device_ms_per_step": device_ms / steps if device_ms else None,
         "device_busy_share": device_ms / traced_ms if device_ms else None,
         "host_ops_per_step": sum(n for _, n in ops.values()) / steps,
         "top_host_ops": [{"name": name, "per_step": n / steps,
                           "ms_per_step": ms / steps} for name, (ms, n) in
                          sorted(ops.items(), key=lambda kv: -kv[1][0])[:6]]}
    log(f"  {label}: {json.dumps(r)}")
    return r


def precision_transformer(device, work):
    """(c) The transformer step in bf16 and fp32 at batch 16 and 1024."""
    out = {}
    for B in PROFILE_BATCHES:
        loader = ArrayLoader(random_dataset(MIMIC_WIDTHS, 8 * B, seed=6), B)
        for dtype in (None, PRECISION_DTYPE):
            model = transformer_model(device)
            model.compute_dtype = dtype
            out[f"{dtype or 'float32'}_{B}"] = trace_steps(
                model, loader, Adam(TRANSFORMER_LR), work,
                f"MIMIC transformer {dtype or 'float32'} batch {B}")
    out["parameters"] = sum(t.numel() for t in tree_leaves(
        transformer_model(device).params))
    return out


class ImageRows:
    """Seeded rows of a 224 x 224 x 3 NHWC image (a share of them NaN) and
    the MIMIC model's 1024-wide source, with two labels."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.img = rng.normal(size=(n, IMAGE_SIZE, IMAGE_SIZE, 3)) \
            .astype(np.float32)
        self.img[rng.random(n) < IMAGE_MISSING] = np.nan
        self.x = rng.normal(size=(n, IMAGE_FEATURES)).astype(np.float32)
        self.y = np.stack([self.x[:, :4].sum(1) > 0, self.x[:, 4:8].sum(1)
                           > 0], 1).astype(np.int64)

    def __len__(self):
        return len(self.y)

    def arrays(self):
        return [self.img, self.x], self.y, None


def image_model(device, dtype=None, seed=0):
    from multimodn_tpu_torch.encoders import ResNet
    return MultiModN(
        MIMIC_STATE, [ResNet(state_size=MIMIC_STATE),
                      MIMICMLPEncoder(MIMIC_STATE, IMAGE_FEATURES,
                                      (MIMIC_HIDDEN,) * 2, dropout=0.0)],
        [MLPDecoder(MIMIC_STATE, (MIMIC_HIDDEN,) * 2, 2)
         for _ in range(MIMIC_TARGETS)], 1.0, 0.0, seed=seed, device=device,
        compute_dtype=dtype)


def check_resnet_update(device, gen):
    """K2 on one update of every leaf of a ResNet-18 (state 50): 4-D HWIO
    kernels, the BatchNorm leaves and the head, both code formats, bit for
    bit; then timed beside the plain version and its bound."""
    shapes = [tuple(t.shape) for t in tree_leaves(
        image_model(device).params["encoders"][0])]
    result = {"leaves": len(shapes), "largest": max(shapes, key=np.prod),
              "launches_per_update": fa.launches_per_update(shapes)}
    for fmt in ("fp8", "int8"):
        leaves = [adam_leaf(s, fmt, gen, device) + [None] for s in shapes]
        bad, err, launches = check_adam_leaves(leaves, fmt)
        result[fmt] = {"mismatches": bad, "max_abs_err": err,
                       "launches": launches}
        if bad or launches != result["launches_per_update"]:
            raise AssertionError(f"K2 on the ResNet leaves ({fmt}): {bad} "
                                 f"mismatching elements, {launches} "
                                 f"launches")
    result["times"] = time_adam(shapes, "fp8", gen, device)
    log(f"  K2 on one update of the {len(shapes)} ResNet-18 leaves: "
        f"{json.dumps(result)}")
    return result


def image_fit(device, dtype, train, val):
    """``fit_best`` of the image model in ``dtype`` through Adam8bit, K2's
    launches counted from 0 over the call."""
    model = image_model(device, dtype)
    torch.cuda.synchronize()
    FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
    t0 = time.perf_counter()
    best = model.fit_best(ArrayLoader(train, IMAGE_BATCH), Adam8bit(ADAM_LR),
                          "cross_entropy", epochs=IMAGE_EPOCHS,
                          val_loader=ArrayLoader(val, IMAGE_BATCH))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = best["epochs_ran"] * ArrayLoader(train, IMAGE_BATCH).n_batches
    per_step = fa.launches_per_update(
        [tuple(t.shape) for t in tree_leaves(model.params)])
    k2 = FUSED_ADAM.launches
    if k2 != per_step * steps or FUSED_CHAIN.launches:
        raise AssertionError(f"image model {dtype}: K2 {k2} launches for "
                             f"{steps} steps of {per_step}")
    masters_fp32(model, f"image model {dtype}")
    if not all(np.isfinite(best["scores"])):
        raise AssertionError(f"image model {dtype}: scores {best['scores']}")
    return model, {"steps": steps, "wall_s": wall, "steps_per_s":
                   steps / wall, "k2_launches": k2,
                   "k2_launches_per_step": per_step,
                   "leaves": len(tree_leaves(model.params)),
                   "scores": [float(s) for s in best["scores"]]}


def masked_bn_check(model, rows, device):
    """Train mode through the chain on one batch whose NaN images keep
    finite pixels but one: the present rows' states must not move when
    those pixels change (the chain passes the effective mask)."""
    img = rows.img[:IMAGE_BATCH].copy()
    nan_rows = np.isnan(img).reshape(IMAGE_BATCH, -1).any(1)
    img[nan_rows] = np.random.default_rng(3).normal(
        size=img[nan_rows].shape).astype(np.float32)
    img[nan_rows, 0, 0, 0] = np.nan
    mask = torch.ones(IMAGE_BATCH, device=device)

    def states(images):
        with torch.no_grad():
            return forward_chain(
                model.encoders, model.init_state, model.params,
                (torch.as_tensor(images, device=device),
                 torch.as_tensor(rows.x[:IMAGE_BATCH], device=device)),
                mask, order=default_order(2), nan_skip="sample",
                train=True)[-1]

    base = states(img)
    moved = img.copy()
    moved[nan_rows] = np.where(np.isnan(img[nan_rows]), np.nan,
                               np.flip(img[nan_rows], axis=1) * 3 + 1)
    present = torch.as_tensor(~nan_rows, device=device)
    diff = float((states(moved) - base)[present].abs().max())
    if not diff <= TOL:
        raise AssertionError(f"masked BatchNorm: present rows moved by "
                             f"{diff} when NaN images' pixels changed")
    return {"nan_rows": int(nan_rows.sum()), "present_rows_max_abs_change":
            diff, "tolerance": TOL}


def precision_images(device, work, gen):
    """(d)."""
    t0 = time.perf_counter()
    rows, val = ImageRows(IMAGE_ROWS, 21), ImageRows(IMAGE_VAL_ROWS, 22)
    data_s = time.perf_counter() - t0
    resnet_update = check_resnet_update(device, gen)
    runs, models = {}, {}
    for dtype in (None, PRECISION_DTYPE):
        models[dtype], runs[dtype or "float32"] = image_fit(
            device, dtype, rows, val)
    k2 = sum(r["k2_launches"] for r in runs.values())
    traced = {}
    for dtype in (None, PRECISION_DTYPE):
        traced[dtype or "float32"] = trace_steps(
            image_model(device, dtype), ArrayLoader(Subset(
                rows, range(IMAGE_TRACE_BATCHES * IMAGE_BATCH)), IMAGE_BATCH),
            Adam8bit(ADAM_LR), work, f"image model {dtype or 'float32'}, "
            f"batch {IMAGE_BATCH}")
    model = models[PRECISION_DTYPE]
    masked = masked_bn_check(model, rows, device)
    present = ~np.isnan(rows.img[:IMAGE_BATCH]).reshape(IMAGE_BATCH, -1) \
        .any(1)
    images = rows.img[:IMAGE_BATCH][present]
    x = [images, rows.x[:IMAGE_BATCH][present]]
    before = model.predict_proba(x)
    enc = model.encoders[0]
    model.params["encoders"][0] = enc.update_batch_stats(
        model.params["encoders"][0], images)
    after = model.predict_proba(x)
    if not all(np.isfinite(a).all() for a in after) or all(
            np.array_equal(a, b) for a, b in zip(after, before)):
        raise AssertionError("update_batch_stats then predict: outputs "
                             "not finite or unchanged")
    cpu_rows = ImageRows(IMAGE_CPU_ROWS, 23)
    device_err = one_step_against_cpu(
        lambda d: image_model(d, seed=1), cpu_rows,
        lambda: Adam8bit(ADAM_LR), ONE_STEP_TOL, "image model, fp32",
        device, IMAGE_CPU_ROWS)
    gpu, cpu = image_model(device, seed=2), image_model("cpu", seed=2)
    cpu.load_state_dict(gpu.state_dict())
    probe = [images[:4], x[1][:4]]
    eval_err = max(float(np.abs(a - b).max()) for a, b in zip(
        gpu.predict_proba(probe), cpu.predict_proba(probe)))
    if not eval_err <= TOL:
        raise AssertionError(f"image model eval outputs, card vs CPU: "
                             f"{eval_err}")
    out = {"image": [IMAGE_SIZE, IMAGE_SIZE, 3], "rows": IMAGE_ROWS,
           "val_rows": IMAGE_VAL_ROWS, "batch": IMAGE_BATCH,
           "epochs": IMAGE_EPOCHS, "nan_share": IMAGE_MISSING,
           "data_s": data_s, "resnet_parameters": sum(
               t.numel() for t in tree_leaves(model.params["encoders"][0])),
           "runs": runs, "traced": traced, "k2_launches": k2,
           "masked_bn": masked,
           "update_batch_stats_then_predict": "finite, changed",
           "device_vs_cpu_max_abs_err": device_err,
           "device_vs_cpu_tolerance": ONE_STEP_TOL,
           "eval_outputs_device_vs_cpu": eval_err}
    log(f"  image model (ResNet-18 + MIMICMLPEncoder): {json.dumps(out)}")
    return out, resnet_update


def run_precision(device, gen):
    """Phase 16."""
    if foreign_modules():
        raise AssertionError(f"loaded before phase 16: {foreign_modules()}")
    work = tempfile.mkdtemp(prefix="chip_smoke_precision_")
    try:
        t0 = time.perf_counter()
        mimic, served, adam_bf16 = precision_bf16_mimic(device, work)
        t1 = time.perf_counter()
        transformer = precision_transformer(device, work)
        t2 = time.perf_counter()
        images, resnet_update = precision_images(device, work, gen)
        t3 = time.perf_counter()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if foreign_modules():
        raise AssertionError(f"loaded by phase 16: {foreign_modules()}")
    return {"mimic_bf16": mimic, "served": served, "adam_bf16": adam_bf16,
            "transformer": transformer, "images": images,
            "resnet_update": resnet_update,
            "seconds": {"mimic": t1 - t0, "transformer": t2 - t1,
                        "images": t3 - t2}}


# ---------------------------------------------------------------------------
# Phase 17: multi-GPU parity (parallel/, MultiModN(mesh=, dp_engine=)).
# The card is one H100, so (a) runs a one-rank NCCL group in this process
# and (b)-(d) two ranks on the same card over gloo (NCCL refuses two ranks
# on one device), started by parallel.dryrun.spawn.
# ---------------------------------------------------------------------------
PAR_TRAIN, PAR_VAL, PAR_EPOCHS = 512, 128, 2
PAR_FOLD_EPOCHS, PAR_SEEDS = 2, (0, 1)
# Two ranks sum gradients and grids in another order than one, so runs on
# different rank counts are held at the JAX package's mesh tolerance (rtol
# 1e-5, atol 1e-6 on parameters). With fp32 Adam that holds in every epoch
# and on the final parameters, on the data axis, on the model axis and for
# the elastic resume (two ranks, then one). With Adam8bit it holds in the
# first epoch only: a moment one ulp apart lands on the neighbouring 8-bit
# code, which moves that parameter by up to lr/8 in a step, and the runs
# drift apart (on the CPU, fp32 Adam stayed within 2e-7 over 3 epochs where
# Adam8bit reached 1.3e-3), so later Adam8bit epochs and the Adam8bit
# elastic resume are held at rtol 1e-2 in their losses, and their
# parameters are not compared across rank counts: where a row's 8-bit v
# code rounds to 0 under a nonzero m code, Adam8bit steps by m / eps, so
# single parameters of runs that differ in their last bits end up far apart
# (0.4 after 3 epochs on the card) while the losses stay within 1e-2.
PAR_RTOL, PAR_ATOL, PAR_RTOL_8BIT = 1e-5, 1e-6, 1e-2
ONE_RANK_BACKEND = "nccl"


def expect_launches(what, got, want):
    if got != want:
        raise AssertionError(f"{what}: {got} launches, expected {want}")


def parallel_arrays(seed=17, batch_mode=False):
    """Seeded MIMIC-width train and val arrays. ``batch_mode``: complete
    rows but for batch 0 of the training data, whose NaNs (modality 1) lie
    only in rows 8-15, the second rank's rows of a 2-way data axis, and
    batch 3's rows 0-3 (modality 2, the first rank's)."""
    rng = np.random.default_rng(seed)
    n, width = PAR_TRAIN + PAR_VAL, sum(MIMIC_WIDTHS)
    X = rng.normal(size=(n, width)).astype(np.float32)
    offsets = np.cumsum((0,) + MIMIC_WIDTHS[:-1])
    w = np.zeros((width, MIMIC_TARGETS), np.float32)
    for off in offsets:
        w[off:off + 8] = rng.normal(size=(8, MIMIC_TARGETS))
    y = (X @ w > 0).astype(np.int64)
    if batch_mode:
        o1, o2 = offsets[1], offsets[2]
        X[8:16, o1:o1 + MIMIC_WIDTHS[1]] = np.nan
        X[48:52, o2:o2 + MIMIC_WIDTHS[2]] = np.nan
    else:
        missing = rng.random((n, len(MIMIC_WIDTHS))) < MISSING_RATE
        for e, (off, wd) in enumerate(zip(offsets, MIMIC_WIDTHS)):
            X[missing[:, e], off:off + wd] = np.nan
    return (X[:PAR_TRAIN], y[:PAR_TRAIN]), (X[PAR_TRAIN:], y[PAR_TRAIN:])


def parallel_loaders(arrays, shuffle=False):
    (X, y), (Xv, yv) = arrays
    return (ArrayLoader(PartitionDataset(X, y, list(MIMIC_WIDTHS)),
                        TRAIN_BATCH, shuffle=shuffle, seed=0),
            ArrayLoader(PartitionDataset(Xv, yv, list(MIMIC_WIDTHS)),
                        TRAIN_BATCH))


def parallel_fit(device, arrays, mesh=None, engine="auto",
                 nan_skip="sample", epochs=PAR_EPOCHS, make_optimizer=None):
    """``fit_best`` with ``Adam8bit`` (or ``make_optimizer()``) on the
    MIMIC model (dropout 0.2); returns the model and the run's numbers, K2
    launches counted over ``fit_best`` alone."""
    optimizer = Adam8bit(ADAM_LR) if make_optimizer is None \
        else make_optimizer()
    model = mimic_model(device if mesh is None else mesh.device,
                        nan_skip=nan_skip, mesh=mesh, dp_engine=engine)
    train_loader, val_loader = parallel_loaders(arrays)
    history = MultiModNHistory([f"t{d}" for d in range(MIMIC_TARGETS)])
    torch.cuda.synchronize(device)
    FUSED_ADAM.launches = 0
    t0 = time.perf_counter()
    best = model.fit_best(train_loader, optimizer, "cross_entropy",
                          epochs=epochs, val_loader=val_loader,
                          history=history)
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    steps = best["epochs_ran"] * train_loader.n_batches
    return model, {
        "train_grids": [np.asarray(g) for g in history.loss["train"]],
        "val_grids": [np.asarray(g) for g in history.loss["val"]],
        "losses": [float(np.mean(g)) for g in history.loss["train"]],
        "scores": [float(s) for s in best["scores"]],
        "best_epoch": best["best_epoch"], "k2_launches": FUSED_ADAM.launches,
        "steps": steps, "seconds": seconds, "steps_per_s": steps / seconds}


def leaf_bits(tree):
    """Every tensor leaf of a tree as host bytes (bit comparisons)."""
    return [t.detach().cpu().reshape(-1).contiguous().view(torch.uint8)
            .numpy() for t in tree_leaves(tree) if torch.is_tensor(t)]


def same_bits(a, b) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def mimic_leaf_shapes(device):
    return [tuple(t.shape) for t in tree_leaves(mimic_model(device).params)]


def parallel_one_rank(device, arrays, batch_arrays):
    """(a) One rank, NCCL, in process: the meshed ``fit_best`` under both
    engines bit-equal to the mesh-free one, K2 once per step."""
    import torch.distributed as dist
    from multimodn_tpu_torch.parallel import make_mesh
    per_step = fa.launches_per_update(mimic_leaf_shapes(device))
    parallel_fit(device, arrays, epochs=1)        # warm-up, not timed
    runs, states = {}, {}
    free, runs["mesh_free"] = parallel_fit(device, arrays)
    states["mesh_free"] = leaf_bits(free.params) + leaf_bits(free.opt_state)
    with tempfile.TemporaryDirectory(prefix="mmn_nccl_") as tmp:
        dist.init_process_group(ONE_RANK_BACKEND,
                                init_method=f"file://{tmp}/rendezvous",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh(device=device)
            for engine in ("auto", "shard_map"):
                model, r = parallel_fit(device, arrays, mesh, engine)
                expect_launches(f"(a) {engine}", r["k2_launches"],
                                per_step * r["steps"])
                bits = leaf_bits(model.params) + leaf_bits(model.opt_state)
                r["bit_equal_to_mesh_free"] = same_bits(
                    bits, states["mesh_free"]) and r["scores"] == runs[
                        "mesh_free"]["scores"] and all(
                    np.array_equal(a, b) for a, b in zip(
                        r["train_grids"], runs["mesh_free"]["train_grids"]))
                if not r["bit_equal_to_mesh_free"]:
                    raise AssertionError(f"(a) one-rank mesh, {engine}: not "
                                         f"bit-equal to the mesh-free run")
                runs[engine] = r
        finally:
            dist.destroy_process_group()
    _, runs["mesh_free_batch"] = parallel_fit(device, batch_arrays,
                                              nan_skip="batch")
    adam_model, runs["mesh_free_adam"] = parallel_fit(
        device, arrays, make_optimizer=lambda: Adam(ADAM_LR))
    runs["mesh_free_adam"]["state"] = adam_model.state_dict()
    for name, r in runs.items():
        log(f"  (a) {name}: {r['steps']} steps, {r['steps_per_s']:.1f} "
            f"steps/s, K2 {r['k2_launches']} launches, losses "
            f"{[round(x, 6) for x in r['losses']]}")
    return runs


def cross_rank_adam(axis, device, shapes, sharded):
    """K2's cross-rank form on this rank's pieces against the plain version
    on the whole leaves, sliced: every sharded MIMIC leaf in one call (the
    optimizer step), (4096, 1024) split 2 ways, and a (2, 65536) leaf with
    a NaN in one row. Returns mismatching elements, launches per call and
    times: the whole call with its gloo MAX between the passes, and the two
    passes alone."""
    b1, b2 = ADAM_BETAS
    gen = torch.Generator(device=device).manual_seed(23)
    cases = {"mimic_step": [s for s, c in zip(shapes, sharded) if c],
             "4096x1024": [(4096, 1024)], "nan_row_2x65536": [(2, 65536)]}
    out = {}
    for name, whole_shapes in cases.items():
        whole = [adam_leaf(s, "fp8", gen, device) + [None]
                 for s in whole_shapes]
        if name.startswith("nan"):
            whole[0][1][1, 40000] = float("nan")
        want = fa.multi_leaf_update_ref(whole, lr=ADAM_LR, b1=b1, b2=b2,
                                        eps=ADAM_EPS, fmt="fp8")

        def cut(t):
            k = t.shape[-1] // axis.size
            return t[..., axis.index * k:(axis.index + 1) * k].contiguous()

        pieces = [[cut(w[0]), cut(w[1]), cut(w[2]), w[3].clone(), cut(w[4]),
                   w[5].clone(), w[6], None] for w in whole]
        split = [True] * len(pieces)
        before = FUSED_ADAM.launches
        fa.multi_leaf_update(pieces, lr=ADAM_LR, b1=b1, b2=b2, eps=ADAM_EPS,
                             fmt="fp8", split=split, row_group=axis)
        torch.cuda.synchronize(device)
        launches = FUSED_ADAM.launches - before
        bad = 0
        for p, w in zip(pieces, want):
            for a, b in ((p[0], cut(w[0])), (p[2], cut(w[1])), (p[3], w[2]),
                         (p[4], cut(w[3])), (p[5], w[4])):
                differ = _bits(a) != _bits(b)
                if a.element_size() != 1:
                    differ &= ~(a.isnan() & b.isnan())
                bad += int(differ.sum())
        local = [tuple(p[0].shape) for p in pieces]
        expect_launches(f"K2 cross-rank {name}", launches,
                        fa.launches_per_update(local, split))
        if bad:
            raise AssertionError(f"K2 cross-rank form, {name}: {bad} "
                                 f"elements differ from the plain version")
        r = {"mismatches": bad, "launches": launches, "leaves": len(local)}
        if name == "mimic_step":
            leaves = [tuple(p) for p in pieces]
            kw = dict(lr=ADAM_LR, b1=b1, b2=b2, eps=ADAM_EPS, fmt="fp8")
            r["ms"] = time_ms(lambda: FUSED_ADAM.launch(
                leaves, tuple(local), split=tuple(split), row_group=axis,
                **kw))
            r["passes_ms"] = time_ms(lambda: FUSED_ADAM.launch(
                leaves, tuple(local), split=tuple(split), **kw))
            r["bound_ms"], r["bound_by"], r["bytes"] = adam_bound(local)
            r["plain_ms"] = time_ms(lambda: fa.multi_leaf_update_ref(
                leaves, split=split, row_group=axis, **kw))
        out[name] = r
    return out


def collective_ms(model, arrays, work, label, steps=8):
    """Collective time per training step from a ``utils.profiling.trace``
    of ``steps`` steps: the CPU time of the ``collective`` regions (each
    blocks until its transfer is done)."""
    from multimodn_tpu_torch.utils import profiling
    (X, y), _ = arrays
    n = steps * TRAIN_BATCH
    loader = ArrayLoader(PartitionDataset(X[:n], y[:n], list(MIMIC_WIDTHS)),
                         TRAIN_BATCH)
    optimizer = Adam8bit(ADAM_LR)
    model.train_epoch(loader, optimizer)            # warm
    torch.cuda.synchronize(model.device)
    with profiling.trace(os.path.join(work, label)) as prof:
        t0 = time.perf_counter()
        model.train_epoch(loader, optimizer)
        torch.cuda.synchronize(model.device)
        wall = time.perf_counter() - t0
    coll = sum(e.cpu_time_total for e in prof.key_averages()
               if e.key == "collective")
    return {"collective_ms_per_step": coll / 1e3 / steps,
            "step_ms": 1e3 * wall / steps, "profiled_steps": steps}


def serve_meshed(model, requests, device):
    """(c) K1 on a meshed model: ``fused_forward`` gathers the whole weights
    once per call and launches K1; answers against the plain chain on the
    whole weights."""
    whole = model._whole_params()
    FUSED_CHAIN.launches = 0
    answers = [model.fused_forward(x) for x in requests]
    torch.cuda.synchronize(device)
    launches = FUSED_CHAIN.launches
    expect_launches("(c) K1 serving", launches,
                    len(requests) * model._chain_spec.launches)
    err = 0.0
    for x, got in zip(requests, answers):
        data = tuple(torch.as_tensor(m, device=device) for m in x)
        states = forward_chain(
            model.encoders, model.init_state, whole, data,
            torch.ones(data[0].shape[0], device=device),
            order=default_order(len(model.encoders)), nan_skip="sample")[0]
        outs = [dec.apply(whole["decoders"][d], states)
                for d, dec in enumerate(model.decoders)]
        err = max(err, max_err(got, (states, outs)))
    if not err <= TOL:
        raise AssertionError(f"(c) K1 on gathered weights: error {err}")
    return {"requests": len(requests), "launches": launches,
            "launches_per_request": launches / len(requests),
            "max_abs_err": err}


def parallel_experiments(device, arrays, fold_mesh):
    """(d) A fold-axis k-fold and a seed-axis sweep over the two ranks."""
    from multimodn_tpu_torch.experiments import kfold_fit_best, \
        sweep_fit_best
    folds, tr, va = parallel_folds(arrays)
    FUSED_ADAM.launches = 0
    kfold = kfold_fit_best(lambda s: mimic_model(device, seed=s), folds,
                           Adam8bit(ADAM_LR), "cross_entropy",
                           epochs=PAR_FOLD_EPOCHS, mesh=fold_mesh)
    sweep = sweep_fit_best(lambda s: mimic_model(device, seed=s), tr, va,
                           Adam8bit(ADAM_LR), "cross_entropy",
                           epochs=PAR_FOLD_EPOCHS, seeds=PAR_SEEDS,
                           mesh=fold_mesh)
    return {"kfold": [result_bits(r) for r in kfold],
            "sweep": [result_bits(r) for r in sweep],
            "k2_launches": FUSED_ADAM.launches}


def parallel_folds(arrays):
    (X, y), (Xv, yv) = arrays
    half = PAR_TRAIN // 2
    ds = PartitionDataset(X, y, list(MIMIC_WIDTHS))
    val = PartitionDataset(Xv, yv, list(MIMIC_WIDTHS))
    folds = [(ArrayLoader(Subset(ds, list(range(f * half, (f + 1) * half))),
                          TRAIN_BATCH), ArrayLoader(val, TRAIN_BATCH))
             for f in range(2)]
    return folds, ArrayLoader(ds, TRAIN_BATCH), ArrayLoader(val,
                                                            TRAIN_BATCH)


def result_bits(r):
    return {"scores": [float(s) for s in r["scores"]],
            "best_epoch": r["best_epoch"],
            "bits": leaf_bits(r["model"].params)}


def parallel_resume(device, arrays, work, mesh, rank):
    """(d) ``fit_best_resumable`` on 2 ranks: uninterrupted, then stopped
    after its first epoch and resumed on 2 ranks; the stopped checkpoint is
    kept for the one-rank (elastic) resume. The same with fp32 ``Adam``,
    uninterrupted and stopped (``work/cut_adam``), for an elastic resume
    held at the tight tolerance."""
    from multimodn_tpu_torch.checkpoint import fit_best_resumable

    class Stop(Exception):
        pass

    def run(ckpt, stop_after=None, make_optimizer=lambda: Adam8bit(ADAM_LR)):
        model = mimic_model(device, mesh=mesh)
        tr, va = parallel_loaders(arrays, shuffle=True)
        history = MultiModNHistory([f"t{d}" for d in range(MIMIC_TARGETS)])

        def on_chunk(done, _total):
            if stop_after is not None and done == stop_after:
                raise Stop
        try:
            r = fit_best_resumable(model, tr, make_optimizer(),
                                   "cross_entropy", epochs=PAR_EPOCHS,
                                   checkpoint_dir=ckpt, val_loader=va,
                                   chunk_epochs=1, on_chunk=on_chunk,
                                   history=history)
        except Stop:
            return None
        return ([float(s) for s in r["scores"]], model.state_dict(),
                history_grids(r["history"]))

    full = run(os.path.join(work, "full"))
    cut = os.path.join(work, "cut")
    run(cut, stop_after=1)
    if rank == 0:
        shutil.copytree(cut, os.path.join(work, "elastic"))
    mesh.everyone.barrier()
    resumed = run(cut)
    equal = full[0] == resumed[0] and all(
        np.array_equal(a, b) for a, b in zip(tree_leaves(full[1]),
                                             tree_leaves(resumed[1])))
    if not equal:
        raise AssertionError("(d) resumed on 2 ranks: not bit-equal to the "
                             "uninterrupted run")
    adam = lambda: Adam(ADAM_LR)                       # noqa: E731
    full_adam = run(os.path.join(work, "full_adam"), make_optimizer=adam)
    run(os.path.join(work, "cut_adam"), stop_after=1, make_optimizer=adam)
    return {"scores": full[0], "grids": full[2], "resumed_bit_equal": equal,
            "adam_scores": full_adam[0], "adam_state": full_adam[1],
            "adam_grids": full_adam[2]}


def max_param_diff(got, want, what):
    """Two state dicts held at the mesh tolerance (rtol 1e-5, atol 1e-6);
    returns the largest absolute difference."""
    diff = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        if not np.allclose(g, w, rtol=PAR_RTOL, atol=PAR_ATOL):
            raise AssertionError(
                f"{what}: parameters {float(np.max(np.abs(g - w)))} apart "
                f"(rtol {PAR_RTOL}, atol {PAR_ATOL})")
        diff = max(diff, float(np.max(np.abs(g - w))))
    return diff


def elastic_loss_diff(elastic, grids, scores, rtol, what):
    """The one-rank resume's loss grids, epoch by epoch, against the
    uninterrupted two-rank run's at ``rtol``; returns the largest relative
    difference."""
    got = history_grids(elastic["history"])
    if len(got) != len(grids):
        raise AssertionError(f"(d) elastic 2 -> 1 resume, {what}: "
                             f"{len(got)} grids, expected {len(grids)}")
    diff = max(float(np.max(np.abs(g - w) / np.abs(w)))
               for g, w in zip(got, grids))
    if not diff <= rtol:
        raise AssertionError(
            f"(d) elastic 2 -> 1 resume, {what}: losses {diff} (relative) "
            f"from the 2-rank run's, rtol {rtol} (scores "
            f"{elastic['scores']} against {scores})")
    return diff


def history_grids(history):
    """A history's train and val loss grids, epoch by epoch."""
    return [np.asarray(g) for tag in ("train", "val")
            for g in history.loss[tag]]


def parallel_rank(rank, world, arrays, batch_arrays, requests, work):
    """(b)-(d) on one of two ranks sharing the card over gloo."""
    from multimodn_tpu_torch.parallel import make_mesh
    from multimodn_tpu_torch.parallel.dryrun import rank_device
    device = torch.device(rank_device())
    exact_math()
    out = {"runs": {}}
    for label, shape, axes, arrs, nan_skip, opt in (
            ("data2_sample", (2,), ("data",), arrays, "sample", Adam8bit),
            ("data2_batch", (2,), ("data",), batch_arrays, "batch",
             Adam8bit),
            ("model2", (1, 2), ("data", "model"), arrays, "sample",
             Adam8bit),
            ("data2_adam", (2,), ("data",), arrays, "sample", Adam),
            ("model2_adam", (1, 2), ("data", "model"), arrays, "sample",
             Adam)):
        mesh = make_mesh(shape, axes, device=device)
        model, r = parallel_fit(device, arrs, mesh, nan_skip=nan_skip,
                                make_optimizer=lambda: opt(ADAM_LR))
        r["k2_launches_per_step"] = r["k2_launches"] / r["steps"]
        split = tree_leaves(model._dp.split)
        r["k2_expected_per_step"] = fa.launches_per_update(
            [tuple(t.shape) for t in tree_leaves(model.params)],
            split if any(split) else None)
        r["local_bits"] = leaf_bits(model.params) + leaf_bits(model.opt_state)
        r["state"] = model.state_dict()
        r["coords"] = dict(mesh.coords)
        r.update(collective_ms(model, arrs, work, f"{label}_{rank}"))
        if label == "model2":
            out["serving"] = serve_meshed(model, requests, device)
            shapes = [tuple(t.shape) for t in tree_leaves(
                model._whole_params())]
            out["k2_cross_rank"] = cross_rank_adam(
                mesh.axis("model"), device, shapes, split)
        out["runs"][label] = r
    fold_mesh = make_mesh((2,), ("fold",), device=device)
    out["experiments"] = parallel_experiments(device, arrays, fold_mesh)
    data_mesh = make_mesh((2,), ("data",), device=device)
    out["resume"] = parallel_resume(device, arrays, work, data_mesh, rank)
    return out


def run_parallel(device, rank_device_name="cuda:0"):
    """Phase 17 (module docstring); returns its numbers."""
    from multimodn_tpu_torch.experiments import kfold_fit_best, \
        sweep_fit_best
    from multimodn_tpu_torch.checkpoint import fit_best_resumable
    from multimodn_tpu_torch.parallel.dryrun import spawn
    t_phase = time.perf_counter()
    arrays, batch_arrays = parallel_arrays(), parallel_arrays(batch_mode=True)
    one = parallel_one_rank(device, arrays, batch_arrays)
    requests = serving_requests(seed=17)
    with tempfile.TemporaryDirectory(prefix="mmn_parallel_") as work:
        t0 = time.perf_counter()
        ranks = spawn(parallel_rank, 2, "gloo", rank_device_name, arrays,
                      batch_arrays, requests, work, timeout=900)
        spawn_s = time.perf_counter() - t0
        # (d) references on one rank: the folds, the seeds, the elastic
        # resume from the 2-rank checkpoint.
        folds, tr, va = parallel_folds(arrays)
        FUSED_ADAM.launches = 0
        kfold = [result_bits(r) for r in kfold_fit_best(
            lambda s: mimic_model(device, seed=s), folds, Adam8bit(ADAM_LR),
            "cross_entropy", epochs=PAR_FOLD_EPOCHS)]
        sweep = [result_bits(r) for r in sweep_fit_best(
            lambda s: mimic_model(device, seed=s), tr, va, Adam8bit(ADAM_LR),
            "cross_entropy", epochs=PAR_FOLD_EPOCHS, seeds=PAR_SEEDS)]
        model = mimic_model(device)
        tr, va = parallel_loaders(arrays, shuffle=True)
        elastic = fit_best_resumable(
            model, tr, Adam8bit(ADAM_LR), "cross_entropy", epochs=PAR_EPOCHS,
            checkpoint_dir=os.path.join(work, "elastic"), val_loader=va,
            chunk_epochs=1)
        ref_k2 = FUSED_ADAM.launches
        adam_model = mimic_model(device)
        tr, va = parallel_loaders(arrays, shuffle=True)
        elastic_adam = fit_best_resumable(
            adam_model, tr, Adam(ADAM_LR), "cross_entropy",
            epochs=PAR_EPOCHS, checkpoint_dir=os.path.join(work, "cut_adam"),
            val_loader=va, chunk_epochs=1)
        elastic_adam["state"] = adam_model.state_dict()
    out = {"one_rank": {k: {n: r[n] for n in (
        "losses", "scores", "best_epoch", "k2_launches", "steps",
        "steps_per_s", "seconds")} for k, r in one.items()}}
    # (b) replicas bit-equal, losses against (a).
    for label, ref in (("data2_sample", "mesh_free"),
                       ("data2_batch", "mesh_free_batch"),
                       ("model2", "mesh_free"),
                       ("data2_adam", "mesh_free_adam"),
                       ("model2_adam", "mesh_free_adam")):
        rs = [r["runs"][label] for r in ranks]
        fp32 = label.endswith("_adam")
        if label.startswith("model2"):
            equal = all(np.array_equal(a, b) for a, b in zip(
                tree_leaves(rs[0]["state"]), tree_leaves(rs[1]["state"])))
        else:
            equal = same_bits(rs[0]["local_bits"], rs[1]["local_bits"])
        if not equal:
            raise AssertionError(f"(b) {label}: the ranks' replicas differ")
        for got, want in ((rs[0]["train_grids"], one[ref]["train_grids"]),
                          (rs[0]["val_grids"], one[ref]["val_grids"])):
            for e, (g, w) in enumerate(zip(got, want)):
                rtol = PAR_RTOL if e == 0 or fp32 else PAR_RTOL_8BIT
                if not np.allclose(g, w, rtol=rtol, atol=0.0):
                    raise AssertionError(
                        f"(b) {label}: epoch {e}'s losses {g} against the "
                        f"one-rank run's {w} (rtol {rtol})")
        if fp32:
            params_diff = max_param_diff(rs[0]["state"], one[ref]["state"],
                                         f"(b) {label}")
        for r in rs:
            expect_launches(f"(b) {label} K2", r["k2_launches"],
                            0 if fp32 else
                            r["steps"] * r["k2_expected_per_step"])
        out[label] = {k: rs[0][k] for k in (
            "losses", "scores", "best_epoch", "steps", "steps_per_s",
            "seconds", "k2_launches_per_step", "collective_ms_per_step",
            "step_ms", "profiled_steps")}
        out[label]["k2_launches"] = sum(r["k2_launches"] for r in rs)
        out[label]["replicas_bit_equal"] = equal
        out[label]["rel_loss_diff_by_epoch"] = [
            float(np.max(np.abs(g - w) / np.abs(w)))
            for g, w in zip(rs[0]["train_grids"], one[ref]["train_grids"])]
        if fp32:
            out[label]["max_abs_param_diff"] = params_diff
    out["k2_cross_rank"] = ranks[0]["k2_cross_rank"]
    out["serving"] = dict(ranks[0]["serving"], launches=sum(
        r["serving"]["launches"] for r in ranks))
    # (d) experiments and checkpoints.
    for kind, want in (("kfold", kfold), ("sweep", sweep)):
        for rank in ranks:
            got = rank["experiments"][kind]
            if [g["scores"] for g in got] != [w["scores"] for w in want] or \
                    not all(same_bits(g["bits"], w["bits"])
                            for g, w in zip(got, want)):
                raise AssertionError(f"(d) {kind} over 2 ranks differs from "
                                     f"the one-rank results")
    full = ranks[0]["resume"]
    elastic_diff = elastic_loss_diff(elastic, full["grids"], full["scores"],
                                     PAR_RTOL_8BIT, "Adam8bit")
    elastic_adam_diff = elastic_loss_diff(
        elastic_adam, full["adam_grids"], full["adam_scores"], PAR_RTOL,
        "fp32 Adam")
    elastic_adam_params = max_param_diff(
        elastic_adam["state"], full["adam_state"], "(d) elastic fp32 Adam")
    out["experiments"] = {
        "kfold_scores": [w["scores"] for w in kfold],
        "sweep_scores": [w["scores"] for w in sweep],
        "equal_to_one_rank": True,
        "resumed_bit_equal": full["resumed_bit_equal"],
        "elastic_scores": [float(s) for s in elastic["scores"]],
        "two_rank_scores": full["scores"],
        "elastic_max_rel_loss_diff": elastic_diff,
        "elastic_adam_scores": [float(s) for s in elastic_adam["scores"]],
        "two_rank_adam_scores": full["adam_scores"],
        "elastic_adam_max_rel_loss_diff": elastic_adam_diff,
        "elastic_adam_max_abs_param_diff": elastic_adam_params,
        "k2_launches": sum(r["experiments"]["k2_launches"] for r in ranks)
        + ref_k2}
    out["k2_launches"] = (sum(one[k]["k2_launches"] for k in one)
                          + sum(out[k]["k2_launches"] for k in (
                              "data2_sample", "data2_batch", "model2",
                              "data2_adam", "model2_adam"))
                          + out["experiments"]["k2_launches"])
    out["k1_launches"] = out["serving"]["launches"]
    out["spawn_s"] = spawn_s
    out["wall_s"] = time.perf_counter() - t_phase
    log("  " + json.dumps({k: out[k] for k in (
        "data2_sample", "data2_batch", "model2", "data2_adam",
        "model2_adam")}))
    log(f"  K2 cross-rank: {json.dumps(out['k2_cross_rank'])}")
    log(f"  serving: {json.dumps(out['serving'])}")
    log(f"  experiments: {json.dumps(out['experiments'])}")
    log(f"  phase 17 wall {out['wall_s']:.1f} s (two-rank world "
        f"{spawn_s:.1f} s)  [{card_line()}]")
    return out


# ---------------------------------------------------------------------------
# Phase 18: every encoder on a mesh. The transformer pipeline's model, phase
# 16's ResNet-18 image model and the Titanic LSTM pipeline's model train on
# two ranks sharing the card over gloo, each run held against the same model
# on one rank. Depth is cut (rows, epochs); the widths are the models' own.
# ---------------------------------------------------------------------------
ENC_ROWS, ENC_VAL, ENC_EPOCHS = 128, 32, 2
ENC_IMAGE_ROWS, ENC_IMAGE_VAL, ENC_IMAGE_BATCH = 64, 32, 32
ENC_TRACE_STEPS = 4
# Rows of each image batch whose image is NaN: the second rank's block of a
# 2-way data axis only.
ENC_IMAGE_NAN = range(20, 24)
# (label, model, mesh shape, mesh axes, optimizer).
ENC_RUNS = (
    ("transformer_model2_adam", "transformer", (1, 2), ("data", "model"),
     "adam"),
    ("transformer_data2_adam", "transformer", (2,), ("data",), "adam"),
    ("transformer_model2_adam8bit", "transformer", (1, 2),
     ("data", "model"), "adam8bit"),
    ("image_data2_adam", "image", (2,), ("data",), "adam"),
    ("image_model2_adam", "image", (1, 2), ("data", "model"), "adam"),
    ("image_model2_adam8bit", "image", (1, 2), ("data", "model"),
     "adam8bit"),
    ("lstm_data2_adam", "lstm", (2,), ("data",), "adam"))
# fp32 Adam runs are held at the mesh tolerance (losses rtol 1e-5 in every
# epoch; each parameter leaf within rtol 1e-5 of its largest magnitude plus
# atol 1e-6), or, leaf by leaf and epoch by epoch, within ENC_FLOOR_FACTOR
# times the distance that reordering each batch's rows (an exact symmetry)
# puts between two one-rank runs, measured in this run: Adam's step is
# scale-free, so a gradient element near its rounding (an attention
# block's key bias, whose true gradient is 0; many of a ResNet's, under
# train-mode BatchNorm) steps by up to lr in a direction that any change of
# summation order can flip, and a mesh changes the summation order as the
# reordering does. The parameter tolerance is the leaf's, not each
# element's, for the same reason at a smaller scale: a small element with
# a small gradient moves by lr times its gradient's relative rounding per
# step. The unbatched LSTM's recurrence runs in row order, so it has no
# such floor and is held at the mesh tolerance alone.
ENC_FLOOR_FACTOR = 4.0
ENC_FLOOR_KINDS = ("transformer", "image")


class EncImageRows:
    """Seeded 224 x 224 x 3 NHWC images (NaN in rows ``ENC_IMAGE_NAN`` of
    every batch, the second rank's) and the MIMIC 1024-wide source, two
    labels."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.img = rng.normal(size=(n, IMAGE_SIZE, IMAGE_SIZE, 3)) \
            .astype(np.float32)
        for b in range(0, n, ENC_IMAGE_BATCH):
            self.img[[b + i for i in ENC_IMAGE_NAN if b + i < n]] = np.nan
        self.x = rng.normal(size=(n, IMAGE_FEATURES)).astype(np.float32)
        self.y = np.stack([self.x[:, :4].sum(1) > 0, self.x[:, 4:8].sum(1)
                           > 0], 1).astype(np.int64)

    def __len__(self):
        return len(self.y)

    def arrays(self):
        return [self.img, self.x], self.y, None


def enc_model(kind, device):
    """The mesh-free model of ``kind`` (seed 0) on ``device``."""
    if kind == "transformer":
        return transformer_model(device)
    if kind == "image":
        return image_model(device)
    from multimodn_tpu_torch.pipelines.titanic import common
    return common.build_model(titanic_pipeline("titanic_lstm").CONFIG, 0,
                              device)


def on_mesh(model, mesh):
    """``model``'s modules, penalties and weights on ``mesh``."""
    out = MultiModN(model.state_size, model.encoders, model.decoders,
                    model.err_penalty, 0.0, nan_skip=model.nan_skip,
                    seed=model._seed, presence_dropout=model.presence_dropout,
                    presence_penalty=model.presence_penalty, mesh=mesh)
    out.state_change_penalty = model.state_change_penalty
    out.load_state_dict(model.state_dict())
    return out


def reordered(n, batch, reorder):
    """Row indices ``0 .. n``, each batch's rows reversed when
    ``reorder``."""
    rows = np.arange(n)
    if reorder:
        for b in range(0, n, batch):
            rows[b:b + batch] = rows[b:b + batch][::-1]
    return rows.tolist()


def enc_loaders(kind, reorder=False, batches=None):
    """The train and validation loaders of ``kind``'s run; ``reorder``
    reverses the rows of each training batch (``ENC_FLOOR_FACTOR``);
    ``batches`` keeps the first training batches only."""
    if kind == "transformer":
        data = random_dataset(MIMIC_WIDTHS, ENC_ROWS + ENC_VAL, seed=18)
        train, val, batch = data, Subset(data, range(
            ENC_ROWS, ENC_ROWS + ENC_VAL)), TRAIN_BATCH
        rows = reordered(ENC_ROWS, batch, reorder)
    elif kind == "image":
        train, val = EncImageRows(ENC_IMAGE_ROWS, 18), EncImageRows(
            ENC_IMAGE_VAL, 19)
        batch = ENC_IMAGE_BATCH
        rows = reordered(ENC_IMAGE_ROWS, batch, reorder)
    else:
        from multimodn_tpu_torch.pipelines.titanic import common
        cfg = titanic_pipeline("titanic_lstm").CONFIG
        split, val, _ = common.split(cfg, 0)
        train, rows, batch = split.dataset, list(split.indices), \
            cfg.batch_size
    if batches is not None:
        rows = rows[:batches * batch]
    return (ArrayLoader(Subset(train, rows), batch),
            ArrayLoader(val, batch))


def enc_optimizer(kind, name):
    lr = titanic_pipeline("titanic_lstm").CONFIG.learning_rate \
        if kind == "lstm" else ADAM_LR
    return (Adam if name == "adam" else Adam8bit)(lr)


def enc_fit(kind, model, opt, reorder=False):
    """``fit_best`` of ``model`` for ``ENC_EPOCHS`` on ``kind``'s data; K2's
    launches counted over the call."""
    train, val = enc_loaders(kind, reorder)
    history = MultiModNHistory([f"t{d}" for d in range(
        len(model.decoders))])
    optimizer = enc_optimizer(kind, opt)
    torch.cuda.synchronize(model.device)
    FUSED_ADAM.launches = FUSED_CHAIN.launches = 0
    t0 = time.perf_counter()
    best = model.fit_best(train, optimizer, "cross_entropy",
                          epochs=ENC_EPOCHS, val_loader=val, history=history)
    torch.cuda.synchronize(model.device)
    seconds = time.perf_counter() - t0
    steps = best["epochs_ran"] * train.n_batches
    if FUSED_CHAIN.launches:
        raise AssertionError(f"phase 18 {kind}: K1 launched in training")
    return {"train_grids": [np.asarray(g) for g in history.loss["train"]],
            "val_grids": [np.asarray(g) for g in history.loss["val"]],
            "losses": [float(np.mean(g)) for g in history.loss["train"]],
            "scores": [float(x) for x in best["scores"]],
            "k2_launches": FUSED_ADAM.launches, "steps": steps,
            "lr": optimizer.lr, "seconds": seconds,
            "steps_per_s": steps / seconds}, optimizer


def enc_collective_ms(model, kind, optimizer, work, label):
    """``ENC_TRACE_STEPS`` more training steps under
    ``utils.profiling.trace``: the CPU time of their ``collective`` regions
    per step (each waits for its transfer) and the traced step's wall
    time."""
    from multimodn_tpu_torch.utils import profiling
    train, _ = enc_loaders(kind, batches=ENC_TRACE_STEPS)
    torch.cuda.synchronize(model.device)
    with profiling.trace(os.path.join(work, label)) as prof:
        t0 = time.perf_counter()
        model.train_epoch(train, optimizer)
        torch.cuda.synchronize(model.device)
        wall = time.perf_counter() - t0
    coll = sum(e.cpu_time_total for e in prof.key_averages()
               if e.key == "collective")
    return {"collective_ms_per_step": coll / 1e3 / train.n_batches,
            "traced_step_ms": 1e3 * wall / train.n_batches}


def cross_rank_step(axis, device, shapes, split, label, timed):
    """K2's cross-rank form on one optimizer step of a model's leaves in one
    ``multi_leaf_update`` call: the split leaves as this rank's columns,
    the others whole beside them, against the plain update of the whole
    leaves, sliced. Returns mismatching elements, launches, and (``timed``)
    the call's time with its gloo MAX, its two passes alone, the plain
    version's time and the bound."""
    b1, b2 = ADAM_BETAS
    gen = torch.Generator(device=device).manual_seed(31)
    whole = [adam_leaf(s, "fp8", gen, device) + [None] for s in shapes]
    want = fa.multi_leaf_update_ref(whole, lr=ADAM_LR, b1=b1, b2=b2,
                                    eps=ADAM_EPS, fmt="fp8")

    def cut(t):
        k = t.shape[-1] // axis.size
        return t[..., axis.index * k:(axis.index + 1) * k].contiguous()

    pieces = [[cut(w[0]), cut(w[1]), cut(w[2]), w[3].clone(), cut(w[4]),
               w[5].clone(), w[6], None] if c else
              [w[0].clone(), w[1]] + [t.clone() for t in w[2:6]] + [w[6],
                                                                   None]
              for w, c in zip(whole, split)]
    before = FUSED_ADAM.launches
    fa.multi_leaf_update(pieces, lr=ADAM_LR, b1=b1, b2=b2, eps=ADAM_EPS,
                         fmt="fp8", split=split, row_group=axis)
    torch.cuda.synchronize(device)
    launches = FUSED_ADAM.launches - before
    local = [tuple(p[0].shape) for p in pieces]
    expect_launches(f"K2 cross-rank {label}", launches,
                    fa.launches_per_update(local, split))
    bad = 0
    for p, w, c in zip(pieces, want, split):
        take = cut if c else (lambda t: t)
        for a, b in ((p[0], take(w[0])), (p[2], take(w[1])), (p[3], w[2]),
                     (p[4], take(w[3])), (p[5], w[4])):
            differ = _bits(a) != _bits(b)
            if a.element_size() != 1:
                differ &= ~(a.isnan() & b.isnan())
            bad += int(differ.sum())
    if bad:
        raise AssertionError(f"K2 cross-rank form, {label}: {bad} elements "
                             f"differ from the plain version")
    r = {"leaves": len(local), "split_leaves": int(sum(split)),
         "parameters": int(sum(np.prod(s) for s in local)),
         "mismatches": bad, "launches": launches}
    if timed:
        leaves = [tuple(p) for p in pieces]
        kw = dict(lr=ADAM_LR, b1=b1, b2=b2, eps=ADAM_EPS, fmt="fp8")
        r["ms"] = time_ms(lambda: FUSED_ADAM.launch(
            leaves, tuple(local), split=tuple(split), row_group=axis, **kw))
        r["passes_ms"] = time_ms(lambda: FUSED_ADAM.launch(
            leaves, tuple(local), split=tuple(split), **kw))
        r["bound_ms"], r["bound_by"], r["bytes"] = adam_bound(local)
        r["plain_ms"] = time_ms(lambda: fa.multi_leaf_update_ref(
            leaves, split=split, row_group=axis, **kw), reps=2, groups=3)
    return r


def tree_digest(*trees) -> str:
    """A digest of the bytes of every tensor or array leaf of ``trees``
    (replica checks without moving the leaves between processes)."""
    import hashlib
    h = hashlib.sha256()
    for tree in trees:
        for t in tree_leaves(tree):
            if torch.is_tensor(t):
                t = t.detach().cpu().reshape(-1).contiguous().view(
                    torch.uint8).numpy()
            if isinstance(t, np.ndarray):
                h.update(np.ascontiguousarray(t).view(np.uint8).tobytes())
    return h.hexdigest()


def encoder_rank(rank, world, work):
    """Phase 18's two-rank runs on one of two ranks sharing the card."""
    from multimodn_tpu_torch.parallel import make_mesh
    from multimodn_tpu_torch.parallel.dryrun import rank_device
    from multimodn_tpu_torch.parallel.sharding import leaf_spec
    device = torch.device(rank_device())
    exact_math()
    out = {"runs": {}, "k2_cross_rank": {}}
    for label, kind, shape, axes, opt in ENC_RUNS:
        mesh = make_mesh(shape, axes, device=device)
        model = on_mesh(enc_model(kind, device), mesh)
        r, optimizer = enc_fit(kind, model, opt)
        split = tree_leaves(model._dp.split)
        r["k2_launches_per_step"] = r["k2_launches"] / r["steps"]
        r["k2_expected_per_step"] = 0 if opt == "adam" else \
            fa.launches_per_update(
                [tuple(t.shape) for t in tree_leaves(model.params)],
                split if any(split) else None)
        r["local_digest"] = tree_digest(model.params, model.opt_state)
        whole = model.state_dict()
        r["state_digest"] = tree_digest(whole)
        r["state"] = whole if rank == 0 else None
        r.update(enc_collective_ms(model, kind, optimizer, work,
                                   f"{label}_{rank}"))
        out["runs"][label] = r
    tp = make_mesh((1, 2), ("data", "model"), device=device)
    for kind in ("transformer", "image", "lstm"):
        shapes = [tuple(t.shape) for t in tree_leaves(
            enc_model(kind, device).params)]
        split = [leaf_spec(s, tp).split_dim() is not None for s in shapes]
        out["k2_cross_rank"][kind] = cross_rank_step(
            tp.axis("model"), device, shapes, split, kind,
            timed=True)
    return out


def spread_check(got, want, floor, what, leafwise):
    """``got`` against ``want`` (lists of arrays): each pair within the
    mesh tolerance, or within ``ENC_FLOOR_FACTOR`` times ``floor``'s
    distance from ``want`` (None: no floor). ``leafwise`` (parameters):
    rtol 1e-5 of the leaf's largest magnitude plus atol 1e-6; else (loss
    grids) rtol 1e-5 of each element. Returns the largest distance, the
    largest ratio to a floor that was needed, and the failures."""
    worst, ratio, failures = 0.0, 0.0, []
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        if not g.size:
            continue
        d = float(np.max(np.abs(g - w)))
        worst = max(worst, d)
        if leafwise:
            if d <= PAR_ATOL + PAR_RTOL * float(np.max(np.abs(w))):
                continue
        elif np.allclose(g, w, rtol=PAR_RTOL, atol=0.0):
            continue
        f = 0.0 if floor is None else float(np.max(np.abs(
            np.asarray(floor[i]) - w)))
        if d <= ENC_FLOOR_FACTOR * f:
            ratio = max(ratio, d / f)
            continue
        failures.append(f"{what}, entry {i}: {d} apart (largest "
                        f"{float(np.max(np.abs(w)))}), beyond the mesh "
                        f"tolerance and {ENC_FLOOR_FACTOR} x the reordered "
                        f"rows' {f}")
    return worst, ratio, failures


def run_parallel_encoders(device, rank_device_name="cuda:0"):
    """Phase 18 (module docstring); returns its numbers. Every run's
    numbers are printed before a failed check raises."""
    from multimodn_tpu_torch.parallel.dryrun import spawn
    t_phase = time.perf_counter()
    one = {}
    for kind, opt in (("transformer", "adam"), ("transformer", "adam8bit"),
                      ("image", "adam"), ("image", "adam8bit"),
                      ("lstm", "adam")):
        model = enc_model(kind, device)
        r, _ = enc_fit(kind, model, opt)
        r["state"] = model.state_dict()
        r["leaves"] = len(tree_leaves(model.params))
        one[(kind, opt)] = r
        if opt == "adam" and kind in ENC_FLOOR_KINDS:
            model = enc_model(kind, device)
            r, _ = enc_fit(kind, model, opt, reorder=True)
            r["state"] = model.state_dict()
            r["leaves"] = len(tree_leaves(model.params))
            one[(kind, "floor")] = r
    with tempfile.TemporaryDirectory(prefix="mmn_encoders_") as work:
        t0 = time.perf_counter()
        ranks = spawn(encoder_rank, 2, "gloo", rank_device_name, work,
                      timeout=900)
        spawn_s = time.perf_counter() - t0
    out = {"one_rank": {f"{k}_{o}": {n: r[n] for n in (
        "losses", "scores", "k2_launches", "steps", "steps_per_s",
        "seconds", "leaves")} for (k, o), r in one.items()}}
    failures = []
    for label, kind, shape, axes, opt in ENC_RUNS:
        rs = [r["runs"][label] for r in ranks]
        ref = one[(kind, opt)]
        fp32 = opt == "adam"
        # A data axis replicates every piece; a model axis, the whole.
        key = "local_digest" if shape == (2,) else "state_digest"
        equal = rs[0][key] == rs[1][key]
        if not equal:
            failures.append(f"{label}: the ranks' replicas differ")
        res = {k: rs[0][k] for k in (
            "losses", "scores", "steps", "steps_per_s", "seconds",
            "k2_launches_per_step", "collective_ms_per_step",
            "traced_step_ms")}
        res["k2_launches"] = sum(r["k2_launches"] for r in rs)
        res["replicas_bit_equal"] = equal
        res["one_rank_steps_per_s"] = ref["steps_per_s"]
        res["rel_loss_diff_by_epoch"] = [
            float(np.max(np.abs(g - w) / np.abs(w)))
            for g, w in zip(rs[0]["train_grids"], ref["train_grids"])]
        for r in rs:
            if r["k2_launches"] != r["steps"] * r["k2_expected_per_step"]:
                failures.append(f"{label}: K2 {r['k2_launches']} launches "
                                f"for {r['steps']} steps of "
                                f"{r['k2_expected_per_step']}")
        if fp32:
            floor = one.get((kind, "floor"))
            grids = ("train_grids", "val_grids")
            _, res["loss_floor_ratio"], bad = spread_check(
                [g for k in grids for g in rs[0][k]],
                [g for k in grids for g in ref[k]],
                None if floor is None else [g for k in grids
                                            for g in floor[k]],
                f"{label} losses", leafwise=False)
            failures += bad
            res["max_abs_param_diff"], res["param_floor_ratio"], bad = \
                spread_check(tree_leaves(rs[0]["state"]),
                             tree_leaves(ref["state"]),
                             None if floor is None else tree_leaves(
                                 floor["state"]), f"{label} parameters",
                             leafwise=True)
            failures += bad
            if floor is not None:
                res["reordered_rows_max_abs_param_diff"] = max(
                    float(np.max(np.abs(a - b))) for a, b in zip(
                        tree_leaves(floor["state"]),
                        tree_leaves(ref["state"])))
        else:
            for grids in ("train_grids", "val_grids"):
                for e, (g, w) in enumerate(zip(rs[0][grids], ref[grids])):
                    rtol = PAR_RTOL if e == 0 else PAR_RTOL_8BIT
                    if not np.allclose(g, w, rtol=rtol, atol=0.0):
                        failures.append(
                            f"{label}: epoch {e}'s {grids} {g} against the "
                            f"one-rank run's {w} (rtol {rtol})")
        out[label] = res
    out["k2_cross_rank"] = ranks[0]["k2_cross_rank"]
    out["k2_launches"] = sum(r["k2_launches"] for r in one.values()) + sum(
        out[label]["k2_launches"] for label, *_ in ENC_RUNS)
    out["spawn_s"] = spawn_s
    out["wall_s"] = time.perf_counter() - t_phase
    for label, *_ in ENC_RUNS:
        log(f"  {label}: {json.dumps(out[label])}")
    log(f"  K2 cross-rank: {json.dumps(out['k2_cross_rank'])}")
    log(f"  phase 18 wall {out['wall_s']:.1f} s (two-rank world "
        f"{spawn_s:.1f} s)  [{card_line()}]")
    if failures:
        raise AssertionError("phase 18: " + "; ".join(failures))
    return out


# Phase 19: K1 with a gradient (make_fused_chain_vjp) at bench_pallas.py's
# two configurations (bench_pallas.py:40-45), with ~30% of valid cells 0.
VJP_CONFIGS = {
    "shipped": {"widths": MIMIC_WIDTHS, "state": 50, "hidden": (32, 32),
                "batch": 1024},
    "scaled": {"widths": (1024,) * 4, "state": 256, "hidden": (1024, 1024),
               "batch": 512},
}
VJP_STEPS, VJP_LR = 10, 1e-3
# Both backwards are the same plain ops on the same inputs; they differ only
# through the loss's cotangent 2 states / N, read from K1's forward (within
# TOL of the plain one) on one side: the loss within 1e-5 relative, each
# gradient leaf within 1e-4 of its largest magnitude. Adam moves a parameter
# by up to lr per step either way where a near-zero gradient's sign rounds
# differently, so ten steps apart by at most 2 x 10 lr.
VJP_LOSS_RTOL, VJP_GRAD_TOL = 1e-5, 1e-4
VJP_STEP_TOL = 2 * VJP_STEPS * VJP_LR
VJP_TOL_REASON = ("the backwards are the same plain ops; they differ only "
                  "through the loss's cotangent 2 states / N, read from "
                  "K1's forward; Adam: up to lr per step either way")


def vjp_model(cfg, device):
    S = cfg["state"]
    return MultiModN(
        S, [MIMICMLPEncoder(S, w, cfg["hidden"], dropout=0.0)
            for w in cfg["widths"]],
        [MLPDecoder(S, cfg["hidden"], 2)], 1.0, 0.0, seed=0, device=device)


def vjp_params(model):
    """The model's layers as fresh leaves that take gradients."""
    return tree_map(lambda t: t.detach().clone().requires_grad_(True),
                    {"encoders": model.params["encoders"],
                     "decoders": model.params["decoders"]})


def vjp_loss(fwd, params, data, valid, init):
    """bench_pallas.py's loss (bench_pallas.py:100-102)."""
    states, outs = fwd(params, data, valid, init)
    return (states ** 2).mean() + sum(o.mean() for o in outs)


def vjp_grads(fwd, model, data, valid, init):
    """The loss and its gradients for every layer leaf, the data and the
    init row."""
    params = vjp_params(model)
    xs = [d.clone().requires_grad_(True) for d in data]
    row = init.clone().requires_grad_(True)
    loss = vjp_loss(fwd, params, xs, valid, row)
    return loss.item(), torch.autograd.grad(
        loss, tree_leaves(params) + xs + [row])


def vjp_train(fwd, model, data, valid, init):
    """``VJP_STEPS`` steps of ``Adam(VJP_LR)`` on the layers: the losses
    and the final leaves."""
    params, opt = vjp_params(model), Adam(VJP_LR)
    state, losses = opt.init(params), []
    for _ in range(VJP_STEPS):
        loss = vjp_loss(fwd, params, data, valid, init)
        leaves = tree_leaves(params)
        by_leaf = dict(zip(map(id, leaves),
                           torch.autograd.grad(loss, leaves)))
        upd, state = opt.update(tree_map(lambda p: by_leaf[id(p)], params),
                                state)
        params = tree_map(lambda p, u: (p + u).detach().requires_grad_(True),
                          params, upd)
        losses.append(loss.item())
    return losses, tree_leaves(params)


def train_bound(spec: ChainSpec, B: int):
    """``bound`` for the loss and the layers' gradients: the forward's
    products, each weight's gradient (one MAC per forward MAC) and each
    product's input gradient except where the input is the data (Stage A's
    jobs); every input read once, each weight's gradient written once."""
    fwd_ms, _by, flops, nbytes = bound(spec, B)
    E = len(spec.encoders)
    data_macs = sum(j.K * j.N for j in spec.a_jobs)
    flops = 3 * flops - 2 * data_macs * B
    nbytes = nbytes - 4 * (E + 1) * B * (
        spec.state_size + sum(d.n_classes for d in spec.decoders)) \
        + 4 * (spec.n_weights + 1)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes)


def run_vjp_config(name, cfg, device, gen):
    model = vjp_model(cfg, device)
    spec = ChainSpec(model.encoders, model.decoders, model.state_size)
    args = (model.encoders, model.decoders, model.state_size)
    plain = make_xla_chain_forward(*args)
    k1 = make_fused_chain_forward(*args)
    trainable = make_fused_chain_vjp(*args)
    B = cfg["batch"]
    data, valid = kernel_inputs(spec, B, gen)
    init = model.params["init_state"]["value"][0].detach().contiguous()
    failures = []

    # The forward: K1 against the plain version, relative to the largest
    # value (the scaled model's states reach past 1).
    with torch.no_grad():
        got = k1(model.params, data, valid, init)
        want = plain(model.params, data, valid, init)
    torch.cuda.synchronize()
    err = max_err(got, want)
    scale = max(t.abs().max().item() for t in [want[0], *want[1]])
    fwd_rel = err / max(scale, 1.0)
    if not fwd_rel <= TOL:
        failures.append(f"{name}: K1's forward {err:.3e} from the plain "
                        f"chain ({fwd_rel:.3e} relative, tol {TOL:g})")
    del got, want

    # The loss and every gradient through K1 against the plain chain.
    loss_k1, grads_k1 = vjp_grads(trainable, model, data, valid, init)
    loss_plain, grads_plain = vjp_grads(plain, model, data, valid, init)
    loss_rel = abs(loss_k1 - loss_plain) / abs(loss_plain)
    grad_rel = max((a - b).abs().max().item() / max(b.abs().max().item(),
                                                    1e-30)
                   for a, b in zip(grads_k1, grads_plain))
    if not loss_rel <= VJP_LOSS_RTOL:
        failures.append(f"{name}: loss {loss_k1} through K1, {loss_plain} "
                        f"plain ({loss_rel:.3e} relative)")
    if not grad_rel <= VJP_GRAD_TOL:
        failures.append(f"{name}: a gradient {grad_rel:.3e} of its leaf's "
                        f"largest value from the plain chain's")
    del grads_k1, grads_plain

    # Ten Adam steps through each: the path whose K1 launches are counted.
    torch.cuda.synchronize()
    FUSED_CHAIN.launches = FUSED_ADAM.launches = 0
    losses_k1, leaves_k1 = vjp_train(trainable, model, data, valid, init)
    torch.cuda.synchronize()
    launches, k2_launches = FUSED_CHAIN.launches, FUSED_ADAM.launches
    losses_plain, leaves_plain = vjp_train(plain, model, data, valid, init)
    param_diff = max((a - b).abs().max().item()
                     for a, b in zip(leaves_k1, leaves_plain))
    loss_diff = max(abs(a - b) / abs(b)
                    for a, b in zip(losses_k1, losses_plain))
    if (launches, k2_launches) != (VJP_STEPS * spec.launches, 0):
        failures.append(f"{name}: {launches} K1 and {k2_launches} K2 "
                        f"launches in {VJP_STEPS} steps, want "
                        f"{VJP_STEPS * spec.launches} and 0")
    if not param_diff <= VJP_STEP_TOL:
        failures.append(f"{name}: parameters {param_diff:.3e} apart after "
                        f"{VJP_STEPS} Adam steps (tol {VJP_STEP_TOL:g})")
    if not all(np.isfinite(losses_k1)) or not losses_k1[-1] < losses_k1[0]:
        failures.append(f"{name}: losses through K1 {losses_k1}")
    del leaves_k1, leaves_plain

    # Times, as bench_pallas.json names them.
    params = vjp_params(model)
    leaves = tree_leaves(params)
    layers = spec.layer_params(model.params)
    with torch.no_grad():
        fwd_plain_ms = time_ms(lambda: plain(model.params, data, valid,
                                             init))
        fwd_k1_ms, per_call = time_counted(
            lambda: k1(model.params, data, valid, init), FUSED_CHAIN)
        packed = spec.pack_data(list(data))
        small_tiles_ms = time_ms(lambda: FUSED_CHAIN.launch(
            spec, layers, packed, valid, init, large_tiles=False))
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        stage_a_blocks = [level[2] for level in
                          spec.stage_a_plan(B, n_sm)[0]]
        stages = stage_times(lambda: k1(model.params, data, valid, init))

    def train_ms(fwd):
        return time_ms(lambda: torch.autograd.grad(
            vjp_loss(fwd, params, data, valid, init), leaves))

    train_plain_ms, train_k1_vjp_ms = train_ms(plain), train_ms(trainable)
    bound_ms, bound_by, flops, nbytes = bound(spec, B)
    tbound_ms, tbound_by, tflops, tbytes = train_bound(spec, B)
    r = {"config": {k: list(v) if isinstance(v, tuple) else v
                    for k, v in cfg.items()},
         "valid_share": valid.mean().item(),
         "fwd_max_abs_err": err, "fwd_rel_err": fwd_rel, "tolerance": TOL,
         "loss_k1": loss_k1, "loss_plain": loss_plain,
         "loss_rel_err": loss_rel, "grad_leaf_rel_err": grad_rel,
         "grad_tolerance": VJP_GRAD_TOL, "steps": VJP_STEPS,
         "losses_k1": losses_k1, "losses_plain": losses_plain,
         "step_loss_rel_diff": loss_diff, "param_max_diff": param_diff,
         "param_tolerance": VJP_STEP_TOL, "launches": launches,
         "launches_per_call": per_call, "fwd_plain_ms": fwd_plain_ms,
         "fwd_k1_ms": fwd_k1_ms, "fwd_k1_small_tiles_ms": small_tiles_ms,
         "stage_ms": stages, "stage_a_blocks": stage_a_blocks,
         "train_plain_ms": train_plain_ms,
         "train_k1_vjp_ms": train_k1_vjp_ms,
         "fwd_bound_ms": bound_ms, "fwd_bound_by": bound_by,
         "fwd_flops": flops, "fwd_bytes": nbytes,
         "train_bound_ms": tbound_ms, "train_bound_by": tbound_by,
         "train_flops": tflops, "train_bytes": tbytes,
         "region_floats": spec.region_len}
    log(f"  {name}: " + json.dumps(r))
    return r, failures


def run_vjp(device):
    """Phase 19: ``make_fused_chain_vjp`` at both configurations."""
    gen = torch.Generator(device=device).manual_seed(19)
    log(f"tolerances: forward {TOL:g} of the largest value, loss "
        f"{VJP_LOSS_RTOL:g} relative, gradients {VJP_GRAD_TOL:g} of each "
        f"leaf's largest value, parameters after {VJP_STEPS} Adam steps "
        f"{VJP_STEP_TOL:g}: {VJP_TOL_REASON}")
    out, failures = {}, []
    for name, cfg in VJP_CONFIGS.items():
        out[name], fails = run_vjp_config(name, cfg, device, gen)
        failures += fails
    out["k1_launches"] = sum(out[n]["launches"] for n in VJP_CONFIGS)
    log(f"  phase 19 [{card_line()}]")
    if failures:
        raise AssertionError("phase 19: " + "; ".join(failures))
    return out


# Phase 20: K1 over the TPU kernel's whole domain, served through
# fused_forward. The featurewise MIMIC chain (RESULTS.md:213-220: one
# MLPFeatureEncoder(50, 32) per feature, 1901 of them, and an
# MLPDecoder(50, (32, 32), 2)) and the MIMIC widths at hidden (2048, 2048)
# with the shipped decoders, seeded weights, 10% of the modality rows
# holding a NaN. --chain-only runs the full set; the main call runs a
# 33-encoder featurewise chain and the wide model at B = 16, so that every
# Stage B variant is checked there.
CHAIN_CONFIGS = {
    "featurewise": {"encoders": FEATUREWISE_E, "batches": (1, 64)},
    "wide": {"hidden": 2048, "batches": (16, 4096)},
}
MAIN_CHAIN_CONFIGS = {
    "featurewise_33": {"encoders": 33, "batches": (16,)},
    "wide": {"hidden": 2048, "batches": (16,)},
}
CHAIN_MISSING = 0.1
CHAIN_REQUESTS = 3        # warm requests timed per path on the host clock


def chain_model(cfg, device, n_encoders=None):
    """Phase 20's model: the featurewise chain at ``cfg["encoders"]`` (or
    ``n_encoders``) features, or the MIMIC widths at ``cfg["hidden"]``."""
    if "encoders" in cfg:
        E = cfg["encoders"] if n_encoders is None else n_encoders
        return MultiModN(
            MIMIC_STATE, [MLPFeatureEncoder(MIMIC_STATE, FEATUREWISE_HIDDEN)
                          for _ in range(E)],
            [MLPDecoder(MIMIC_STATE, (MIMIC_HIDDEN,) * 2, 2)], 1.0, 0.0,
            seed=20, device=device)
    return MultiModN(
        MIMIC_STATE, [MIMICMLPEncoder(MIMIC_STATE, w, (cfg["hidden"],) * 2,
                                      dropout=0.0) for w in MIMIC_WIDTHS],
        [MLPDecoder(MIMIC_STATE, (MIMIC_HIDDEN,) * 2, 2)
         for _ in range(MIMIC_TARGETS)], 1.0, 0.0, seed=20, device=device)


def chain_request(model, B, seed):
    """B rows per modality; in 10% of each modality's rows a NaN, so that
    the row's state is kept for that step."""
    rng = np.random.default_rng(seed)
    x = [rng.normal(size=(B, e.n_features)).astype(np.float32)
         for e in model.encoders]
    for m in x:
        m[rng.random(B) < CHAIN_MISSING, 0] = np.nan
    return x


def host_ms(fn, reps=CHAIN_REQUESTS) -> float:
    """Median host-clock ms of ``fn`` to its answer on the device."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def run_chain_config(name, cfg, device):
    model = chain_model(cfg, device)
    spec = ChainSpec(model.encoders, model.decoders, model.state_size)
    E = len(model.encoders)
    # The launches per call of the same family at E = 4.
    small = chain_model(cfg, device, 4) if "encoders" in cfg else model
    torch.cuda.synchronize()
    FUSED_CHAIN.launches = 0
    small.fused_forward(chain_request(small, 2, 0))
    torch.cuda.synchronize()
    e4_launches = FUSED_CHAIN.launches
    init = model.params["init_state"]["value"][0].contiguous()
    layers = spec.layer_params(model.params)
    long_chain = E > 100
    out, failures = {}, []
    for B in cfg["batches"]:
        x = chain_request(model, B, seed=B)
        # The main path: one request through fused_forward, counted.
        torch.cuda.synchronize()
        FUSED_CHAIN.launches = 0
        states, outs = model.fused_forward(x)
        torch.cuda.synchronize()
        launches = FUSED_CHAIN.launches
        packed, valid = model._packed_request(x, spec)
        want = fused_chain_forward_ref(spec, model.params, packed, valid,
                                       init)
        torch.cuda.synchronize()
        err = max_err((states, outs), want)
        scale = max(t.abs().max().item() for t in [want[0], *want[1]])
        rel = err / max(scale, 1.0)
        finite = all(torch.isfinite(t).all().item()
                     for t in [states, *outs])
        variant, smem, chunk, stages = FUSED_CHAIN.stage_b_config(
            spec, B, device)
        del want

        def kernel():
            FUSED_CHAIN.launch(spec, layers, packed, valid, init)

        reps = (2, 3) if long_chain else (TIMED_REPS, TIMED_GROUPS)
        ms = time_ms(kernel)
        plain_ms = time_ms(lambda: fused_chain_forward_ref(
            spec, model.params, packed, valid, init), *reps)
        stage_ms = stage_times(kernel, calls=5)
        bound_ms, bound_by, flops, nbytes = bound(spec, B)
        request_ms = host_ms(lambda: model.fused_forward(x))
        proba_ms = host_ms(lambda: model.predict_proba(x), 2 if long_chain
                           else CHAIN_REQUESTS)
        r = {"encoders": E, "batch": B, "stage_b": VARIANTS[variant],
             "stage_b_shared_bytes": smem, "chunk": chunk,
             "ring_stages": stages, "valid_share": valid.mean().item(),
             "max_abs_err": err, "rel_err": rel, "tolerance": TOL,
             "launches": launches, "launches_per_call": launches,
             "launches_at_e4": e4_launches, "ms": ms, "plain_ms": plain_ms,
             "stage_ms": stage_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "flops": flops, "bytes": nbytes,
             "fused_forward_request_ms": request_ms,
             "predict_proba_request_ms": proba_ms,
             "region_floats": spec.region_len,
             "plan_ints": len(spec.plan)}
        log(f"  {name} B={B}: " + json.dumps(r))
        out[str(B)] = r
        if not finite or not rel <= TOL:
            failures.append(f"{name} B={B}: K1 {err:.3e} from the plain "
                            f"chain ({rel:.3e} of the largest value, tol "
                            f"{TOL:g}, finite={finite})")
        if launches != spec.launches or launches != e4_launches:
            failures.append(f"{name} B={B}: {launches} K1 launches per "
                            f"call, the plan {spec.launches}, at E = 4 "
                            f"{e4_launches}")
        del states, outs, packed, valid
    return out, failures


def run_chain(device, configs=CHAIN_CONFIGS):
    """Phase 20: the featurewise chain and the wide MIMIC model through
    ``fused_forward``."""
    log(f"tolerance: {TOL:g} of the largest value ({TOL_REASON})")
    out, failures = {}, []
    for name, cfg in configs.items():
        out[name], fails = run_chain_config(name, cfg, device)
        failures += fails
    out["k1_launches"] = sum(r["launches"] for c in configs
                             for r in out[c].values())
    log(f"  phase 20 [{card_line()}]")
    if failures:
        raise AssertionError("phase 20: " + "; ".join(failures))
    return out


def build_kernels():
    """Build every kernel library at once (one nvcc per source)."""
    with ThreadPoolExecutor(max_workers=3) as pool:
        futures = [pool.submit(k.library) for k in (FUSED_CHAIN, FUSED_ADAM,
                                                     FUSED_ADAM_FP32)]
        for f in futures:
            f.result()
    for name in ("fused_chain.cu", "fused_adam.cu", "fused_adam_fp32.cu"):
        with open(library_path(name) + ".log") as f:
            log(name + ": " + " ".join(
                line.strip() for line in f
                if "registers" in line or "spill" in line))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--all-protocols", action="store_true",
                   help="run phase 1 and the published-protocol runner "
                        "(phase 8) at the published scale (300 patients, "
                        "100 epochs, 5 folds, every stage) or at the "
                        "values below, and end with the protocol line (no "
                        "kernel build, no ok line)")
    p.add_argument("--patients", type=int, default=FULL_PATIENTS,
                   help="with --all-protocols: synthetic patients")
    p.add_argument("--epochs", type=int, default=FULL_EPOCHS,
                   help="with --all-protocols: epochs of each fold")
    p.add_argument("--nfold", type=int, default=FULL_FOLDS,
                   help="with --all-protocols: folds")
    p.add_argument("--stages", type=int, nargs="+", default=[1, 2, 3, 4],
                   choices=(1, 2, 3, 4),
                   help="with --all-protocols: the runner's stages to run")
    p.add_argument("--keep", default=None, metavar="DIR",
                   help="with --all-protocols: copy the results CSVs here")
    p.add_argument("--orders-only", action="store_true",
                   help="run phases 1, 2 and 13 (encoding orders) only and "
                        "end with the orders line (no ok line)")
    p.add_argument("--dropin-only", action="store_true",
                   help="run phases 1, 2 and 14 (the drop-in torch surface) "
                        "only and end with the dropin line (no ok line)")
    p.add_argument("--experiments-only", action="store_true",
                   help="run phases 1, 2 and 15 (the experiment surface and "
                        "ahead-of-time serving) only and end with the "
                        "experiments line (no ok line)")
    p.add_argument("--precision-only", action="store_true",
                   help="run phases 1, 2 and 16 (mixed precision and the "
                        "ResNet image model) only and end with the "
                        "precision line (no ok line)")
    p.add_argument("--parallel-only", action="store_true",
                   help="run phases 1, 2, 17 and 18 (multi-GPU parity: one "
                        "rank over NCCL, two ranks on the card over gloo; "
                        "every encoder on a mesh) only and end with the "
                        "parallel_encoders line (no ok line)")
    p.add_argument("--vjp-only", action="store_true",
                   help="run phases 1, 2 and 19 (K1 with a gradient at "
                        "bench_pallas.py's two configurations) only and end "
                        "with the vjp line (no ok line)")
    p.add_argument("--chain-only", action="store_true",
                   help="run phases 1, 2 and 20 (K1 over the whole domain: "
                        "the 1901-encoder featurewise chain at B = 1 and "
                        "64, the MIMIC widths at hidden 2048 at B = 16 and "
                        "4096) only and end with the chain line (no ok "
                        "line)")
    p.add_argument("--adam-only", action="store_true",
                   help="run phases 1, 2 and 5 (K2 and K3 against their "
                        "plain versions, and their times) only and end with "
                        "the adam line (no ok line)")
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

    phase("phase 1: device")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    if args.all_protocols:
        phase("phase 8: the published-protocol runner")
        protocol = run_all_protocols(device, args.patients, args.epochs,
                                     args.nfold, args.stages, args.keep)
        log("protocol: " + json.dumps(protocol))
        log(f"chip_smoke wall time {time.perf_counter() - START:.1f} s")
        log(card)
        return 0

    phase("phase 2: build")
    t0 = time.perf_counter()
    build_kernels()
    log(f"fused_chain.cu, fused_adam.cu and fused_adam_fp32.cu built and "
        f"loaded in {time.perf_counter() - t0:.2f} s")
    if args.orders_only:
        phase("phase 13: encoding orders")
        log("orders: " + json.dumps(run_orders(device)))
        log(f"chip_smoke wall time {time.perf_counter() - START:.1f} s")
        log(card)
        return 0
    if args.dropin_only:
        phase("phase 14: drop-in torch surface")
        log("dropin: " + json.dumps(run_dropin(device)))
        log(f"chip_smoke wall time {time.perf_counter() - START:.1f} s")
        log(card)
        return 0
    if args.experiments_only:
        phase("phase 15: experiments and ahead-of-time serving")
        log("experiments: " + json.dumps(run_experiments(device)))
        log(f"chip_smoke wall time {time.perf_counter() - START:.1f} s")
        log(card)
        return 0
    if args.parallel_only:
        phase("phase 17: multi-GPU parity")
        log("parallel: " + json.dumps(run_parallel(device)))
        phase("phase 18: every encoder on a mesh")
        log("parallel_encoders: " + json.dumps(run_parallel_encoders(
            device)))
        log(f"chip_smoke wall time {time.perf_counter() - START:.1f} s")
        log(card)
        return 0
    if args.vjp_only:
        phase("phase 19: K1 with a gradient")
        log("vjp: " + json.dumps(run_vjp(device)))
        log(f"chip_smoke wall time {time.perf_counter() - START:.1f} s")
        log(card)
        return 0
    if args.chain_only:
        phase("phase 20: K1 over the whole domain")
        log("chain: " + json.dumps(run_chain(device)))
        log(f"chip_smoke wall time {time.perf_counter() - START:.1f} s")
        log(card)
        return 0
    if args.adam_only:
        phase("phase 5: the fused Adam kernels against plain")
        log(f"tolerance {ADAM_TOL:g}: {ADAM_TOL_REASON}")
        gen = torch.Generator(device=device).manual_seed(0)
        log("adam: " + json.dumps({"k2": check_adam(device, gen),
                                   "k3": check_adam_fp32(device, gen)}))
        log(f"chip_smoke wall time {time.perf_counter() - START:.1f} s")
        log(card)
        return 0
    if args.precision_only:
        phase("phase 16: mixed precision and the ResNet image model")
        log("precision: " + json.dumps(run_precision(
            device, torch.Generator(device=device).manual_seed(16))))
        log(f"chip_smoke wall time {time.perf_counter() - START:.1f} s")
        log(card)
        return 0

    phase("phase 3: kernel against plain")
    log(f"tolerance {TOL:g}: {TOL_REASON}")
    gen = torch.Generator(device=device).manual_seed(0)
    mimic = check_kernel("mimic", mimic_model(device), KERNEL_BATCHES, gen)
    check_kernel("small-last-concat", small_model(device), (7, 1000), gen)

    phase("phase 4: serving")
    launches, serving = serve(device)

    phase("phase 5: the fused Adam kernels against plain")
    log(f"tolerance {ADAM_TOL:g}: {ADAM_TOL_REASON}")
    adam = check_adam(device, gen)
    adam_fp32 = check_adam_fp32(device, gen)

    phase("phase 6: training")
    runs = check_training(device)
    profile = profile_training(device)

    phase("phase 7: card against CPU")
    device_err = check_device_vs_cpu(device)

    phase("phase 8: the published-protocol runner")
    log(card_line())
    protocol = run_all_protocols(device, PROTOCOL_PATIENTS, PROTOCOL_EPOCHS,
                                 PROTOCOL_FOLDS)

    phase("phase 9: Titanic")
    log(card_line())
    titanic = run_titanic(device)

    phase("phase 10: a lambda-trained MNAR model served")
    log(card_line())
    mnar_served = serve_mnar_model(device)

    phase("phase 11: transformer")
    log(card_line())
    transformer = run_transformer(device)

    phase("phase 12: resumable fits, streaming and disk loaders")
    log(card_line())
    resume = run_resume(device)

    phase("phase 13: encoding orders")
    log(card_line())
    orders = run_orders(device)

    phase("phase 14: drop-in torch surface")
    log(card_line())
    dropin = run_dropin(device)

    phase("phase 15: experiments and ahead-of-time serving")
    log(card_line())
    experiments = run_experiments(device)

    phase("phase 16: mixed precision and the ResNet image model")
    log(card_line())
    precision = run_precision(device, gen)

    phase("phase 17: multi-GPU parity")
    log(card_line())
    parallel = run_parallel(device)

    phase("phase 18: every encoder on a mesh")
    log(card_line())
    encoders = run_parallel_encoders(device)

    phase("phase 19: K1 with a gradient")
    log(card_line())
    vjp = run_vjp(device)

    phase("phase 20: K1 over the whole domain")
    log(card_line())
    chain = run_chain(device, MAIN_CHAIN_CONFIGS)
    k1_by_phase = {
        "4": launches,
        "9": sum(r["launches"] for r in titanic["served"].values()),
        "10": mnar_served["launches"],
        "12": resume["served"]["launches"],
        "13": orders["mimic"]["served"]["launches"],
        "14": sum(r["launches"] for r in dropin["served"].values()),
        "15": experiments["artifact"]["k1_launches"],
        "16": precision["served"]["launches"],
        "17": parallel["k1_launches"],
        "19": vjp["k1_launches"],
        "20": chain["k1_launches"]}
    k2_by_phase = {
        "6": runs["Adam8bit"]["launches"],
        "12": sum(resume["resume"][kind]["k2_launches"]
                  for kind in ("array", "stream")),
        "13": orders["mimic"]["k2_launches"] + sum(
            r["k2_launches"] for r in orders["featurewise"].values()),
        "15": sum(experiments[k]["k2_launches"]
                  for k in ("sweep", "kfold", "trace")),
        "16": precision["mimic_bf16"]["bf16"]["k2_launches"]
        + precision["images"]["k2_launches"],
        "17": parallel["k2_launches"],
        "18": encoders["k2_launches"]}

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
            "bound_by", "stage_ms", "small_tiles_ms", "stage_b") if k in r}
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
        "experiments": experiments["artifact"],
        "precision": {k: precision["served"][k] for k in (
            "pipeline", "requests", "launches", "launches_per_request",
            "max_abs_err", "batch", "ms", "plain_ms", "bound_ms",
            "bound_by")},
        "parallel": parallel["serving"],
        "vjp": {name: {k: vjp[name][k] for k in (
            "launches", "launches_per_call", "fwd_rel_err",
            "grad_leaf_rel_err", "param_max_diff", "fwd_plain_ms",
            "fwd_k1_ms", "fwd_k1_small_tiles_ms", "train_plain_ms",
            "train_k1_vjp_ms", "fwd_bound_ms", "fwd_bound_by",
            "train_bound_ms", "train_bound_by")} for name in VJP_CONFIGS},
        "chain": {name: {B: {k: r[k] for k in (
            "encoders", "stage_b", "launches", "launches_at_e4",
            "max_abs_err", "rel_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "fused_forward_request_ms",
            "predict_proba_request_ms")} for B, r in chain[name].items()}
            for name in MAIN_CHAIN_CONFIGS},
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
        "experiments": {k: {n: experiments[k][n] for n in (
            "k2_launches", "steps")} for k in ("sweep", "kfold", "trace")},
        "precision": {
            "mimic_bf16": {k: precision["mimic_bf16"]["bf16"][k] for k in (
                "k2_launches", "steps")},
            "images": {dtype: {k: r[k] for k in (
                "k2_launches", "steps", "k2_launches_per_step", "leaves")}
                for dtype, r in precision["images"]["runs"].items()},
            "resnet_update": precision["resnet_update"]},
        "parallel": {"cross_rank": parallel["k2_cross_rank"], **{
            label: {k: parallel[label][k] for k in (
                "k2_launches", "steps", "k2_launches_per_step")}
            for label in ("data2_sample", "data2_batch", "model2")}},
        "parallel_encoders": {"cross_rank": encoders["k2_cross_rank"], **{
            label: {k: encoders[label][k] for k in (
                "k2_launches", "steps", "k2_launches_per_step")}
            for label, *_ in ENC_RUNS if label.endswith("adam8bit")}},
    }
    k3_step = adam_fp32["times"]["fp32"]
    k3_entry = {
        "name": "fused_adam_fp32",
        "route": "cuda",
        "source": "multimodn_tpu_torch/csrc/fused_adam_fp32.cu",
        # The JAX package's fp32 Adam is plain jnp, fused by XLA.
        "replaces": None,
        "launches": FUSED_ADAM_FP32.launches,
        "mismatches": sum(r["mismatches"] for k, r in adam_fp32.items()
                          if k.endswith("gated")),
        "tolerance": ADAM_TOL,
        # One optimizer step of the image-model cell: all 133 leaves.
        "ms": k3_step["ms"],
        "plain_ms": k3_step["per_leaf"]["device_ms"],
        "bound_ms": k3_step["bound_ms"],
        "bound_by": k3_step["bound_by"],
        # No PyTorch call is a kernel of this repository's (the foreach
        # and fused forms of torch.optim.Adam are library kernels).
        "library_ms": None,
        "leaves_per_step": adam_fp32["leaves"],
        "launches_per_step": adam_fp32["launches_per_step"],
        "training_launches": runs["Adam"]["k3_launches"],
        "steps": runs["Adam"]["steps"],
        "by_state": adam_fp32["times"],
    }
    log("earlier designs (not measured in this run): "
        + json.dumps(EARLIER))
    log("protocol: " + json.dumps(protocol))
    log("titanic: " + json.dumps({k: titanic[k] for k in (
        "pipelines", "quickstart", "profile")}))
    log("mnar: " + json.dumps({"served": mnar_served}))
    log("transformer: " + json.dumps(transformer))
    log("resume: " + json.dumps({k: resume[k] for k in (
        "resume", "disk", "pipelines", "payload_write", "rates")}))
    log("orders: " + json.dumps(orders))
    log("dropin: " + json.dumps(dropin))
    log("experiments: " + json.dumps(experiments))
    log("precision: " + json.dumps(precision))
    log("parallel: " + json.dumps(parallel))
    log("parallel_encoders: " + json.dumps(encoders))
    log("vjp: " + json.dumps(vjp))
    log("chain: " + json.dumps(chain))
    log(json.dumps({"kernels": [entry, adam_entry, k3_entry]}))
    log(f"chip_smoke wall time {time.perf_counter() - START:.1f} s")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
