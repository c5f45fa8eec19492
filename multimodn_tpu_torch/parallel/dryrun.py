"""Run a function on several ranks, and the multi-device dry run.

``spawn(fn, world_size, backend, device, *args)`` starts one process per
rank with ``torch.multiprocessing`` (the ``spawn`` start method), joins them
in one process group through a ``file://`` rendezvous in a temporary
directory, gives each rank one CPU thread, calls ``fn(rank, world_size,
*args)`` and returns every rank's return value in rank order. A rank that
raises, dies or outlives ``timeout`` fails the whole call: the other ranks
are stopped and ``RuntimeError`` carries the failing rank's traceback.

``device`` is where the ranks compute: ``'cpu'``, ``'cuda'`` (rank ``r`` on
``cuda:r``) or one card for every rank (``'cuda:0'``, with the ``gloo``
backend: NCCL refuses two ranks on one card). Left out, it is the card
(``default_device``): ``'cuda'`` when there is a card for every rank, else
``'cuda:0'``; without a GPU the caller must name the CPU. Each rank's device
is in the ``MMN_RANK_DEVICE`` environment variable, which ``rank_device()``
reads.

``dryrun_multichip(n)`` is the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: a DP x TP mesh when ``n`` is even and
4 or more (else DP), a MIMIC-shaped model, and ``fit_best`` through the
public API; it checks that the run trained, that the replicas agree bit for
bit, and returns rank 0's summary.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.multiprocessing as mp


def rank_device() -> str:
    """The device ``spawn`` gave the calling rank."""
    return os.environ["MMN_RANK_DEVICE"]


def default_device(world_size: int) -> str:
    """The ranks' device when the caller names none (module docstring)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the ranks "
            "on the CPU")
    return "cuda" if torch.cuda.device_count() >= world_size else "cuda:0"


def _rank_main(rank, world_size, backend, device, rdzv, out_dir, fn, args):
    os.environ["MMN_RANK_DEVICE"] = device if device != "cuda" \
        else f"cuda:{rank}"
    os.environ["LOCAL_RANK"] = str(rank if device == "cuda" else 0)
    torch.set_num_threads(1)
    import torch.distributed as dist
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        if os.environ["MMN_RANK_DEVICE"].startswith("cuda"):
            torch.cuda.set_device(torch.device(os.environ["MMN_RANK_DEVICE"]))
        dist.init_process_group(backend, init_method=f"file://{rdzv}",
                                rank=rank, world_size=world_size)
        try:
            result = ("ok", fn(rank, world_size, *args))
        finally:
            dist.destroy_process_group()
    except Exception:       # reported to the parent, which fails the call
        result = ("error", traceback.format_exc())
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)
    if result[0] == "error":
        raise SystemExit(1)


def spawn(fn: Callable, world_size: int, backend: str = "gloo",
          device: Optional[str] = None, *args,
          timeout: float = 600.0) -> list:
    """``fn(rank, world_size, *args)`` on ``world_size`` ranks (module
    docstring); returns the per-rank results."""
    if device is None:
        device = default_device(world_size)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mmn_ranks_") as tmp:
        rdzv = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(
            r, world_size, backend, device, rdzv, tmp, fn, args))
            for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(f"ranks still running after "
                                       f"{timeout:.0f} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join()
        results, errors = [], []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r} exited with code {p.exitcode} "
                              f"and no result")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status == "error":
                errors.append(f"rank {r} raised:\n{value}")
            results.append(value)
        if errors:
            raise RuntimeError("\n".join(errors))
        return results


def _dryrun_rank(rank, world_size, n_steps):
    import numpy as np

    from multimodn_tpu_torch import Adam8bit, MultiModN
    from multimodn_tpu_torch.data import ArrayLoader, PartitionDataset
    from multimodn_tpu_torch.decoders import MLPDecoder
    from multimodn_tpu_torch.encoders import MIMICMLPEncoder
    from multimodn_tpu_torch.core.tree import tree_leaves
    from multimodn_tpu_torch.parallel import make_mesh

    device = rank_device()
    if world_size % 2 == 0 and world_size >= 4:
        mesh = make_mesh((world_size // 2, 2), ("data", "model"),
                         device=device)
    else:
        mesh = make_mesh((world_size,), ("data",), device=device)
    dp = mesh.shape["data"]
    state_size, widths = 8, [10, 64, 48, 12]
    rng = np.random.default_rng(0)
    n = 8 * dp
    X = rng.normal(size=(n, sum(widths))).astype(np.float32)
    X[rng.random(n) < 0.3, :10] = np.nan
    y = (np.nan_to_num(X[:, :4]).sum(axis=1) > 0).astype(np.int64)
    tr, va, _ = PartitionDataset(X, y, widths).random_split(
        (0.75, 0.25, 0), seed=0)
    model = MultiModN(
        state_size,
        [MIMICMLPEncoder(state_size, w, (32, 32), dropout=0.0)
         for w in widths],
        [MLPDecoder(state_size, (32, 32), 2)], 1.0, 0.0, mesh=mesh)
    w_enc = model.params["encoders"][0]["layers"][0]["w"]
    if "model" in mesh.axis_names:
        assert w_enc.shape[1] == 32 // mesh.shape["model"], \
            "TP sharding not applied through MultiModN(mesh=)"
    before = model.state_dict()
    res = model.fit_best(ArrayLoader(tr, 2 * dp), Adam8bit(1e-3),
                         "cross_entropy", epochs=n_steps,
                         val_loader=ArrayLoader(va, 2 * dp))
    assert res["best_epoch"] >= 0, "selection never improved on -inf"
    assert np.isfinite(res["best_score"]), "non-finite selection score"
    assert np.isfinite(res["scores"]).all()
    after = model.state_dict()
    assert not np.allclose(before["decoders"][0]["layers"][0]["w"],
                           after["decoders"][0]["layers"][0]["w"]), \
        "params unchanged after fit_best"
    # Every replica of a piece holds the same bits.
    local = [t.cpu().numpy() for t in tree_leaves(model.params)]
    pieces = mesh.everyone.all_gather_object(
        (mesh.coords.get("model", 0), local))
    mine = mesh.coords.get("model", 0)
    for coord, other in pieces:
        if coord == mine:
            assert all(np.array_equal(a, b) for a, b in zip(local, other)), \
                "replicas disagree"
    return {"mesh": dict(mesh.shape), "best_epoch": res["best_epoch"],
            "best_score": float(res["best_score"]),
            "scores": res["scores"].tolist()}


def dryrun_multichip(n: int, backend: str = "gloo",
                     device: Optional[str] = None, epochs: int = 3) -> dict:
    """The multi-device dry run on ``n`` ranks (module docstring); returns
    rank 0's ``{"mesh", "best_epoch", "best_score", "scores"}``."""
    results = spawn(_dryrun_rank, n, backend, device, epochs)
    first = results[0]
    for r in results[1:]:
        if r["scores"] != first["scores"]:
            raise AssertionError("ranks disagree on the selection scores")
    return first
