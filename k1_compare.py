"""K1's device times at the shapes that PERF.md reports, for one or more
trees of this repository, each timed in a process of its own on one card.

    python3 k1_compare.py                                # this tree alone
    python3 k1_compare.py --tree parent=DIR --tree change=. --order ABBA

``--tree NAME=DIR`` names a directory that holds a ``multimodn_tpu_torch``
package (a checkout, or ``git archive <commit> multimodn_tpu_torch``
unpacked). ``--order`` lists the runs by the trees' letters in the order
given (A the first tree): ``ABBA`` times two trees as first, second,
second, first, so that a drift of the card's clock over the call falls on
both alike; the default runs each tree once. Each process imports the package from its tree and builds the
tree's kernels under its ``build/``, so two versions of the source never
share a library.

Shapes (the K1 rows of PERF.md): the MIMIC model (widths 10, 1024, 768, 99,
state 50, hidden (32, 32), two 2-class MLPDecoders) at B = 1, 16 and 65536;
``bench_pallas.py``'s shipped shape (the same widths, one MLPDecoder) at B =
1024, as ``make_fused_chain_vjp``'s forward reaches it; the Titanic MLP
(state 1, ``MLPEncoder(1, 6, (5, 5))``, a ``LogisticDecoder``) and the
partitioned Titanic model (state 5, encoders of 3 and 2 features, hidden
(5, 5)) at B = 16. For each: ``op_ms``, the device time of one call of
``fused_chain_forward`` on the E modality tensors (CUDA events around 20
calls queued behind a sleep kernel, median of 5 groups), which holds any
copy the wrapper makes before its kernels; the device time of each K1
kernel per call (``torch.profiler``); K1's launches per call; and the
tree's ptxas report (registers and spills of each kernel). One JSON line
per run, then a table. Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

SHAPES = (("mimic", 1), ("mimic", 16), ("mimic", 65536),
          ("shipped", 1024), ("titanic_mlp", 16),
          ("titanic_partitioned", 16))
KERNELS = ("stage_a_gemm", "segment_softmax", "chain_kernel",
           "layered_kernel")
REPS, GROUPS = 20, 5


def _models(MultiModN, enc, dec, device):
    mimic = (10, 1024, 768, 99)

    def model(S, encoders, decoders):
        return MultiModN(S, encoders, decoders, 1.0, 0.0, seed=0,
                         device=device)

    return {
        "mimic": lambda: model(50, [enc.MIMICMLPEncoder(50, w, (32, 32),
                                                        dropout=0.0)
                                    for w in mimic],
                               [dec.MLPDecoder(50, (32, 32), 2)
                                for _ in range(2)]),
        "shipped": lambda: model(50, [enc.MIMICMLPEncoder(50, w, (32, 32),
                                                          dropout=0.0)
                                      for w in mimic],
                                 [dec.MLPDecoder(50, (32, 32), 2)]),
        "titanic_mlp": lambda: model(1, [enc.MLPEncoder(1, 6, (5, 5))],
                                     [dec.LogisticDecoder(1)]),
        "titanic_partitioned": lambda: model(
            5, [enc.MLPEncoder(5, n, (5, 5)) for n in (3, 2)],
            [dec.LogisticDecoder(5)]),
    }


def time_ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(GROUPS):
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / REPS)
    return statistics.median(means)


def kernel_ms(torch, fn, calls=20) -> dict:
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
        for k in KERNELS:
            if k in e.key and e.self_device_time_total > 0:
                out[k] = out.get(k, 0.0) + \
                    e.self_device_time_total / 1e3 / calls
    return out


def ptxas_report(text: str) -> dict:
    """{kernel's mangled name: [registers, spill store bytes]}."""
    out = {}
    for part in text.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        if regs:
            out[name] = [int(regs.group(1)),
                         int(spill.group(1)) if spill else 0]
    return out


def run_tree(root: str) -> dict:
    """Times every shape with the package of ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from multimodn_tpu_torch import MultiModN
    from multimodn_tpu_torch import decoders as dec
    from multimodn_tpu_torch import encoders as enc
    from multimodn_tpu_torch.ops import fused_chain as fc
    from multimodn_tpu_torch.ops.build import library_path
    assert fc.__file__.startswith(os.path.abspath(root)), fc.__file__
    device = torch.device("cuda")
    models = _models(MultiModN, enc, dec, device)
    rows = {}
    for name, B in SHAPES:
        model = models[name]()
        spec = fc.ChainSpec(model.encoders, model.decoders,
                            model.state_size)
        gen = torch.Generator(device=device).manual_seed(B)
        data = [torch.randn((B, e.n_features), generator=gen, device=device)
                for e in model.encoders]
        valid = (torch.rand((B, len(data)), generator=gen, device=device)
                 >= 0.3).float()
        init = model.params["init_state"]["value"][0].contiguous()
        params = model.params

        def call():
            return fc.fused_chain_forward(spec, params, data, valid, init)

        got, want = call(), fc.fused_chain_forward_ref(spec, params, data,
                                                       valid, init)
        err = max((g - w).abs().max().item()
                  for g, w in zip([got[0], *got[1]], [want[0], *want[1]]))
        before = fc.FUSED_CHAIN.launches
        op_ms = time_ms(torch, call)
        launches = (fc.FUSED_CHAIN.launches - before) / (1 + REPS * GROUPS)
        rows[f"{name} B={B}"] = {"op_ms": op_ms,
                                 "kernel_ms": kernel_ms(torch, call),
                                 "launches": launches, "max_abs_err": err}
        del model, data, valid, got, want
        torch.cuda.empty_cache()
    log_path = library_path("fused_chain.cu") + ".log"
    report = {}
    if os.path.exists(log_path):
        with open(log_path) as f:
            report = ptxas_report(f.read())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    return {"root": os.path.abspath(root), "card": card,
            "ptxas": report, "shapes": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR; repeat for several trees")
    ap.add_argument("--order", default=None,
                    help="runs by tree letter, e.g. ABBA (default: each "
                         "tree once)")
    ap.add_argument("--run", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k1_compare.py needs a CUDA card", file=sys.stderr)
        return 1
    if args.run is not None:
        print(json.dumps(run_tree(args.run)), flush=True)
        return 0
    trees = [t.split("=", 1) for t in args.tree] or [["this", "."]]
    order = [ord(c) - ord("A") for c in args.order] if args.order \
        else list(range(len(trees)))
    if not order or not all(0 <= i < len(trees) for i in order):
        ap.error(f"--order names trees A..{chr(ord('A') + len(trees) - 1)}")
    results = []
    for i in order:
        name, root = trees[i]
        root = os.path.abspath(root)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run", root],
            capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        r["tree"] = name
        results.append(r)
        print(json.dumps(r), flush=True)
    print(f"card: {results[0]['card']}")
    for r in [results[order.index(i)] for i in sorted(set(order))]:
        print(f"{r['tree']}: ptxas [registers, spill bytes]")
        for name, (regs, spill) in sorted(r["ptxas"].items()):
            print(f"  {regs:4d} {spill:5d}  {name}")
    head = "shape".ljust(24) + "".join(
        f"{r['tree']:>34}" for r in results)
    print(head + "\n" + " " * 24 + "".join(
        f"{'op_ms / stage A / stage B':>34}" for _ in results))
    for shape in results[0]["shapes"]:
        line = shape.ljust(24)
        for r in results:
            s = r["shapes"][shape]
            k = s["kernel_ms"]
            b = k.get("chain_kernel", 0.0) + k.get("layered_kernel", 0.0)
            line += (f"{s['op_ms']:>14.4f} {k.get('stage_a_gemm', 0.0):>9.4f}"
                     f" {b:>9.4f}")
        print(line)
    worst = max(s["max_abs_err"] for r in results
                for s in r["shapes"].values())
    print(f"largest error against the plain chain: {worst:.3e}")
    return 0 if worst <= 1e-4 else 1


if __name__ == "__main__":
    sys.exit(main())
