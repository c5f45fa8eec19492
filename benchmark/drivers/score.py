"""Requests of many rows to ``MultiModN.fused_forward`` from one client in
a closed loop: each request's answers (every decoder's outputs on all E+1
states) reach the host before the next request starts.

A pool of ``chunks`` distinct requests is made from the seed, on the card
(``inputs: device``) or on the host as numpy (``inputs: host``); request i
sends chunk ``i % chunks``. The check compares requests drawn from the seed
among the first ``checked_within``, and the last one, against the plain
reference over the same inputs: every decoder output on every state row,
and every state."""
import sys
import time

import numpy as np
import torch

from benchmark.harness import weights as W
from benchmark.harness.runner import exact_math, tf32_math
from benchmark.modules import build
from benchmark.reference import chain


def _reference_answer(params, cfg):
    def answer(x):
        rows = chain.states(params, cfg, x)
        return rows, chain.outputs(params, cfg, rows)
    return answer


def setup(run):
    cfg, tr, dev = run.cell.config, run.cell.traffic, run.device
    specs = chain.leaves(cfg)
    weights = W.make_tree(specs, run.seed, dev)
    initial = W.clone(weights)
    pool = [W.modalities(cfg, tr["rows"], tr["missing"], run.seed, 10 + c,
                         dev) for c in range(tr["chunks"])]
    present = [[int((~torch.isnan(x.reshape(len(x), -1)).any(dim=1)).sum())
                for x in chunk] for chunk in pool]
    sent = pool if tr["inputs"] == "device" else \
        [[x.cpu().numpy() for x in chunk] for chunk in pool]
    model = build(cfg, weights, dev)
    if run.side == "tf32":
        # The control: the reference, in TF32, in the program's place.
        ref_params = W.clone(initial)
        reference = _reference_answer(ref_params, cfg)

        def serve(x):
            tf32_math()
            with torch.no_grad():
                out = reference([torch.as_tensor(m, device=dev) for m in x])
            exact_math()
            return out
    else:
        serve = model.fused_forward
    gen = np.random.default_rng(run.seed)
    keep = set(gen.choice(tr["checked_within"], tr["checked_requests"],
                          replace=False).tolist())
    state = {"model": model, "serve": serve, "pool": pool, "sent": sent,
             "initial": initial, "present": present, "keep": keep,
             "kept": {}}
    for i in range(tr["warmup_requests"]):
        _request(state, run, i % tr["chunks"])
    run.sync()
    return state


def _request(state, run, chunk):
    """One request: the call, then its answers on the host."""
    with run.span("score.fused_forward"):
        states, outs = state["serve"](state["sent"][chunk])
    return states, [o.cpu() for o in outs]


def traced_slice(traffic) -> dict:
    return {"requests": traffic["trace_requests"]}


def window(state, run, seconds=None, requests=None):
    chunks = run.cell.traffic["chunks"]
    latencies = []
    kept = state["kept"]
    kept.clear()
    i = 0
    run.sync()
    start = end = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        states, answers = _request(state, run, i % chunks)
        end = time.perf_counter()
        latencies.append(end - t0)
        if i in state["keep"]:
            kept[i] = (i % chunks, states, answers)
        i += 1
        if (requests is not None and i >= requests) or \
                (requests is None and end - start >= seconds):
            break
    kept[i - 1] = ((i - 1) % chunks, states, answers)
    done = np.cumsum(latencies)
    per_second = np.bincount(done.astype(int)) if len(done) else []
    print("requests per second of the window: "
          + " ".join(str(int(n)) for n in per_second), file=sys.stderr)
    return {"window_s": end - start, "requests": i,
            "latencies": latencies}


def results(state, stats):
    rows = run_rows(state)
    lat = np.asarray(stats["latencies"])
    return ({"score_rows_per_s": stats["requests"] * rows
             / stats["window_s"],
             "request_p95_ms": float(np.percentile(lat, 95)) * 1e3},
            stats["requests"], 0)


def run_rows(state):
    return int(state["pool"][0][0].shape[0])


def counts(run, state, stats):
    cfg, chunks = run.cell.config, run.cell.traffic["chunks"]
    rows = run_rows(state)
    peak = run.cell.peak(run.kind)
    per_chunk = [run.cell.counts.forward_macs(cfg, p, rows)
                 for p in state["present"]]
    bounds = [run.cell.counts.k1_bound(cfg, p, rows, peak)[0]
              for p in state["present"]]
    n = stats["requests"]
    calls = [n // chunks + (1 if c < n % chunks else 0)
             for c in range(chunks)]
    return {"requests": n,
            "useful_flops": 2 * sum(c * m for c, m in zip(calls, per_chunk)),
            "k1_bound_s": sum(c * b for c, b in zip(calls, bounds)),
            "peak_flops": "fp32_flops"}


def release(state):
    for key in ("model", "serve", "sent"):
        state.pop(key, None)


def check(state, run):
    """The largest gap of an answer and of a state (against the largest
    state) between the program and the reference, over the kept
    requests."""
    cfg = run.cell.config
    reference = _reference_answer(state["initial"], cfg)
    answers_gap = states_gap = 0.0
    with torch.no_grad():
        for chunk, states, answers in state["kept"].values():
            ref_states, ref_outs = reference(state["pool"][chunk])
            scale = float(ref_states.abs().max())
            states_gap = max(states_gap, float(
                (states - ref_states).abs().max()) / scale)
            for got, want in zip(answers, ref_outs):
                answers_gap = max(answers_gap, float(
                    (got.to(want.device) - want).abs().max()))
    return [("answers_gap", answers_gap), ("states_gap", states_gap)]
