#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``multimodn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card's name and power limit, torch and CUDA versions; TF32 off;
2. build the fused-chain kernel from ``multimodn_tpu_torch/csrc``;
3. the kernel against its plain PyTorch version at the MIMIC multi-task
   model (B = 1, 16, 1000, 65536, ~30% of modality cells invalid) and at a
   small last-concat model with gelu/tanh encoders and softmax heads: max
   abs error, kernel and plain times (CUDA events), and the bound;
4. serving: a seeded MIMIC model goes through ``export_model`` ->
   ``load_model`` and answers 8 requests of batch 16 (some with NaN rows)
   through ``fused_forward``; each answer is checked against the plain
   chain, ``InferenceSession`` must reproduce its state rows, and the
   kernel's launch count must equal the number of requests;
5. one ``{"kernels": [...]}`` line, the card's line, and last the
   ``{"ok": true, ...}`` line.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from multimodn_tpu_torch import InferenceSession, MultiModN, export_model, \
    load_model
from multimodn_tpu_torch.core.fusion import default_order, forward_chain
from multimodn_tpu_torch.decoders import ClassDecoder, LogisticDecoder, \
    MLPDecoder
from multimodn_tpu_torch.encoders import MIMICMLPEncoder, MLPEncoder
from multimodn_tpu_torch.ops.build import library_path
from multimodn_tpu_torch.ops.fused_chain import FUSED_CHAIN, ChainSpec, \
    fused_chain_forward, fused_chain_forward_ref

ROOT = os.path.dirname(os.path.abspath(__file__))
# MIMIC multi-task model at the defaults of pipelines/mimic/common.py.
MIMIC_STATE, MIMIC_WIDTHS, MIMIC_HIDDEN, MIMIC_TARGETS = 50, (10, 1024, 768,
                                                              99), 32, 2
KERNEL_BATCHES = (1, 16, 1000, 65536)
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


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def mimic_model(device, seed=0):
    encoders = [MIMICMLPEncoder(MIMIC_STATE, w, (MIMIC_HIDDEN,) * 2,
                                dropout=0.2) for w in MIMIC_WIDTHS]
    decoders = [MLPDecoder(MIMIC_STATE, (MIMIC_HIDDEN,) * 2, 2)
                for _ in range(MIMIC_TARGETS)]
    return MultiModN(MIMIC_STATE, encoders, decoders, 1.0, 0.0, seed=seed,
                     device=device)


def small_model(device):
    S = 24
    encoders = [MLPEncoder(S, 40, (64,), "gelu"),
                MLPEncoder(S, 7, (16, 16), "tanh"),
                MLPEncoder(S, 13, ())]
    decoders = [ClassDecoder(S, 5, "softmax"),
                MLPDecoder(S, (16,), 3, "softmax", "gelu"),
                LogisticDecoder(S)]
    return MultiModN(S, encoders, decoders, 1.0, 0.0, seed=1, device=device)


def time_ms(fn, reps=20, groups=5) -> float:
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


def check_kernel(name, model, batches, gen):
    """Kernel against plain at each B; returns per-B records."""
    spec = ChainSpec(model.encoders, model.decoders, model.state_size)
    params = model.params
    weights = spec.flatten_params(params)
    init_row = model.params["init_state"]["value"][0].contiguous()
    records = {}
    for B in batches:
        data, valid = kernel_inputs(spec, B, gen)
        got = fused_chain_forward(spec, params, data, valid, init_row)
        want = fused_chain_forward_ref(spec, params, data, valid, init_row)
        torch.cuda.synchronize()
        err = max_err(got, want)
        finite = all(torch.isfinite(t).all().item()
                     for t in [got[0], *got[1]])
        ms = time_ms(lambda: FUSED_CHAIN.launch(spec, weights, data, valid,
                                                init_row))
        plain_ms = time_ms(lambda: fused_chain_forward_ref(
            spec, params, data, valid, init_row))
        bound_ms, bound_by, flops, nbytes = bound(spec, B)
        records[B] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "flops": flops, "bytes": nbytes}
        log(f"  {name} B={B}: max_abs_err={err:.3e} (tol {TOL:g}) "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}; {flops:.4g} FLOP, "
            f"{nbytes:.4g} B), {bound_ms / ms:.2%} of bound")
        if not finite or not err <= TOL:
            raise AssertionError(
                f"{name} B={B}: kernel disagrees with the plain version "
                f"(max abs err {err}, finite={finite})")
        del data, valid, got, want
    return records


def serving_requests(seed=0):
    """8 requests of batch 16; some rows have a NaN modality (whole row or
    a single entry) so the per-sample skip is exercised."""
    rng = np.random.default_rng(seed)
    requests = []
    for r in range(SERVING_REQUESTS):
        x = [rng.normal(size=(SERVING_BATCH, w)).astype(np.float32)
             for w in MIMIC_WIDTHS]
        if r % 2 == 0:
            for e in range(len(x)):
                rows = rng.choice(SERVING_BATCH, size=3, replace=False)
                x[e][rows[:2]] = np.nan
                x[e][rows[2], rng.integers(x[e].shape[1])] = np.nan
        requests.append(x)
    return requests


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
    log(f"  {len(requests)} requests: K1 launches {launches}; request "
        f"latency (host clock, first call included) ms: "
        + ", ".join(f"{t:.3f}" for t in latencies))
    if launches != len(requests):
        raise AssertionError(f"K1 launched {launches} times for "
                             f"{len(requests)} fused_forward calls")

    err_chain = err_session = 0.0
    n_enc = len(model.encoders)
    session = InferenceSession(model)
    for x, (states, outs) in zip(requests, answers):
        if not all(torch.isfinite(t).all().item() for t in [states, *outs]):
            raise AssertionError("fused_forward gave non-finite values")
        if states.shape != (n_enc + 1, SERVING_BATCH, MIMIC_STATE):
            raise AssertionError(f"states shape {tuple(states.shape)}")
        data = tuple(torch.as_tensor(m, device=device) for m in x)
        ref_states = forward_chain(
            model.encoders, model.init_state, model.params, data,
            torch.ones(SERVING_BATCH, device=device),
            order=default_order(n_enc), nan_skip="sample")[0]
        ref_outs = [dec.apply(model.params["decoders"][d], ref_states)
                    for d, dec in enumerate(model.decoders)]
        err_chain = max(err_chain, max_err((states, outs),
                                           (ref_states, ref_outs)))
        state = session.init(SERVING_BATCH)
        for e in range(n_enc):
            state, probs = session.step(state, e, x[e])
            err_session = max(err_session, max_err(
                (state, [torch.as_tensor(p, device=device) for p in probs]),
                (states[e + 1], [o[e + 1] for o in outs])))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")

    log("== phase 1: device")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    log("== phase 2: build")
    t0 = time.perf_counter()
    FUSED_CHAIN.library()
    log(f"fused_chain.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    with open(library_path("fused_chain.cu") + ".log") as f:
        log("".join(line for line in f if "registers" in line or
                    "spill" in line).strip())

    log("== phase 3: kernel against plain")
    log(f"tolerance {TOL:g}: {TOL_REASON}")
    gen = torch.Generator(device=device).manual_seed(0)
    mimic = check_kernel("mimic", mimic_model(device), KERNEL_BATCHES, gen)
    check_kernel("small-last-concat", small_model(device), (7, 1000), gen)

    log("== phase 4: serving")
    launches, serving = serve(device)

    main_b = mimic[SERVING_BATCH]
    entry = {
        "name": "fused_chain",
        "route": "cuda",
        "source": "multimodn_tpu_torch/csrc/fused_chain.cu",
        "replaces": "multimodn_tpu/ops/fused_chain.py:132",
        "launches": launches,
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
        "by_batch": {str(B): {k: r[k] for k in ("max_abs_err", "ms",
                                                "plain_ms", "bound_ms",
                                                "bound_by")}
                     for B, r in mimic.items()},
    }
    log(json.dumps({"kernels": [entry]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
