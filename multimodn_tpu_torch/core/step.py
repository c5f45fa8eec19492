"""Batch loss, training and evaluation epochs, selection (PyTorch twin of
``multimodn_tpu/core/step.py``).

PyTorch runs eagerly, so an epoch is a Python loop over ``(batch,
n_real)`` pairs: forward, ``torch.autograd.grad``, the optimizer. Per-batch
grid sums and log scalars stay on the device and are summed at the end of
the epoch; the caller copies them to the host once per epoch
(``to_host``). The pairs come from an ``ArrayLoader``'s epoch stacks
(``stack_batches``: modality tensors ``(n_batches, B, F_m)``, targets
``(n_batches, B, D)``, a sample mask ``(n_batches, B)`` that is 0 on padded
tail rows) or from a streaming loader (``data.streaming.device_batches``),
through the same code.

The batch loss routes an order as the JAX package does: a static order
runs the unrolled chain, or executions plus ``combine_executions`` when it
repeats an encoder; per-batch sequences and the in-program shuffle run the
traced chains (``core/scan_chain.py``): ``forward_chain`` on each batch's
pairs. The MNAR mitigations of
``nan_skip='sample'`` (``presence_dropout``, ``presence_penalty``) act in
training only.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from multimodn_tpu_torch.core.fusion import (
    combine_executions,
    decode_grid,
    forward_chain,
    forward_chain_executions,
    has_repeated_encoders,
    sample_missing,
    switch_widths,
)
from multimodn_tpu_torch.core.metrics import masked_binary_auroc, safe_div
from multimodn_tpu_torch.core.nn import uniform
from multimodn_tpu_torch.core.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from multimodn_tpu_torch.utils.profiling import span

STATIC_ORDER_MESSAGE = (
    "presence_penalty needs a STATIC modality order (no shuffle_mode, "
    "per-batch encoding sequences, or repeated encoders): the penalty "
    "reconstructs execution-order state deltas from the row-indexed stack.")
REPEATS_NEED_UNROLLED = (
    "encoding sequences with REPEATED encoders need the unrolled chain: the "
    "traced-order chains keep one metric row per encoder and cannot express "
    "the reference's per-execution accumulation (multimodn.py:171-192). Use "
    "chain_mode='unrolled' (or 'auto').")
GRID_KEYS = ("err_loss", "state_change", "n_correct", "tp", "tn", "fp", "fn",
             "n_counted")


def draw_presence_dropout(generator: torch.Generator, batch: int,
                          n_modalities: int, p: float,
                          device) -> torch.Tensor:
    """(B, M) boolean mask: each (sample, modality) pair dropped with
    probability ``p``, one Bernoulli draw per modality from ``generator``."""
    return torch.stack([uniform((batch,), generator, device) < p
                        for _ in range(n_modalities)], dim=1)


def inject_presence_dropout(data: Sequence[torch.Tensor],
                            drop: torch.Tensor) -> tuple:
    """Write NaN into every feature of each dropped (sample, modality) pair
    of ``drop`` (B, M); the chain's NaN skip then treats the pair as absent
    (JAX ``core/step.py:124-141``)."""
    out = []
    for m, x in enumerate(data):
        shape = (-1,) + (1,) * (x.dim() - 1)
        out.append(torch.where(drop[:, m].reshape(shape),
                               torch.full_like(x, float("nan")), x))
    return tuple(out)


def presence_penalty_term(states: torch.Tensor, data: Sequence[torch.Tensor],
                          sample_mask: torch.Tensor,
                          order: Sequence[Tuple[int, int]],
                          axis=None) -> torch.Tensor:
    """The missingness-weighted mean squared state change over PRESENT rows,
    averaged over the execution steps of the static ``order`` (JAX
    ``core/step.py:143-191``): step k, ``(d, e) = order[k]``, reads the
    change from the previous step's row (row 0 first) to row ``e + 1``,
    weighted by modality ``d``'s missing fraction among the valid rows.

    ``axis``: on a mesh, the data axis. The counts (valid, missing and
    present rows) carry no gradient and are summed over it in one
    ``all_reduce``, so they are the global batch's; the present-row delta
    sums stay the rank's own, so the rank's term is its share of the
    global one and the terms of the ranks add up to it (JAX's
    ``shard_map`` engine reaches the same by dividing by its loss scale)."""
    valid = sample_mask > 0
    missing = [sample_missing(data[d]) for d, _e in order]
    counts = torch.stack([sample_mask.float().sum()]
                         + [(m & valid).float().sum() for m in missing]
                         + [((~m) & valid).float().sum() for m in missing])
    if axis is not None:
        counts = axis.all_reduce(counts)
    k = len(order)
    n_valid = counts[0].clamp_min(1.0)
    prev = states[0]
    pen = torch.zeros((), device=states.device)
    for i, (_d, e) in enumerate(order):
        cur = states[e + 1]
        miss_frac = counts[1 + i] / n_valid
        present = ((~missing[i]) & valid).float()
        delta = ((cur.float() - prev.float()) ** 2).mean(dim=-1)
        present_delta = (delta * present).sum() / \
            counts[1 + k + i].clamp_min(1.0)
        pen = pen + miss_frac * present_delta
        prev = cur
    return pen / max(len(order), 1)


def make_batch_loss_fn(encoders, decoders, init_state, criterion,
                       err_penalty: float, state_change_penalty: float,
                       order: Sequence[Tuple[int, int]], nan_skip: str,
                       chain: str = "unrolled", presence_dropout: float = 0.0,
                       presence_penalty: float = 0.0, shuffle: bool = False,
                       per_batch_seq: bool = False, compute_dtype=None):
    """``loss_fn(params, data, targets, sample_mask, generator, init_offset,
    train, drop=None, seq=None, perm=None, batch_stats=None) -> (loss, aux)``
    for one padded batch.

    The loss is the reference's (multimodn.py:194-202): the grid mean times
    ``err_penalty`` plus the mean state change times
    ``state_change_penalty``, which arrives already scaled by the
    constructor's 0.01 (quirk #1). ``aux["enc_gates"]`` holds the (E,)
    executed flags under ``nan_skip='batch'``, the one mode in which the
    reference's torch optimizer skips parameters, and None otherwise.

    ``chain``: ``'unrolled'`` runs the static ``order`` (executions plus
    ``combine_executions`` when it repeats an encoder); ``'scan'`` (the
    first encoder's computation for every step, homogeneous encoders) and
    ``'switch'`` run the traced chains. ``per_batch_seq``: the batch's
    order is ``seq``, an (L,) encoder sequence paired with modalities 0..L-1
    (reference ``multimodn.py:516-525``), on a traced chain. ``shuffle``:
    in training, the ``(data_idx, enc_idx)`` pairs are taken in the order
    ``perm`` gives (the reference's ``random.shuffle`` of the pairs,
    ``multimodn.py:527-529``; JAX ``core/step.py:215-224``); the caller
    draws ``perm``.

    MNAR mitigations for ``nan_skip='sample'``, in training only:
    ``presence_dropout`` (p) re-marks each (sample, modality) pair missing
    with probability p before the chain runs, from ``drop`` when given,
    else drawn from ``generator`` (``draw_presence_dropout``);
    ``presence_penalty`` (lambda) adds ``lambda * presence_penalty_term`` on
    the injected data. It needs a static order that repeats no encoder. The
    history's grids do not include it.

    ``compute_dtype`` (a torch dtype, or None for fp32): mixed precision as
    in the JAX package (``core/step.py:195-202``). Every floating parameter
    leaf and modality array is cast to it before the presence dropout, in
    training and evaluation alike; NaN survives the cast, so the skip still
    sees it. Losses, metrics and penalties reduce in fp32 (``decode_grid``,
    ``masked_mean_sq_diff``), and the casts are differentiable, so the
    gradients reach the fp32 master parameters as fp32.

    ``batch_stats``: on a mesh, the rank's rows of a global batch with the
    batch's global quantities (``parallel.dp_step.BatchStats``): the
    whole-batch NaN flags drive ``nan_skip='batch'``, the loss is the
    rank's share of the global one (times ``batch_stats.scale``), and the
    presence penalty takes global counts."""
    if chain not in ("unrolled", "scan", "switch"):
        raise ValueError(f"chain must be 'unrolled', 'scan' or 'switch', "
                         f"got {chain!r}")
    if per_batch_seq and chain not in ("scan", "switch"):
        raise ValueError("per_batch_seq requires chain='scan' or 'switch'")
    traced = chain in ("scan", "switch")
    repeats = not per_batch_seq and has_repeated_encoders(order)
    if repeats and traced:
        raise ValueError(REPEATS_NEED_UNROLLED)
    if presence_dropout or presence_penalty:
        if nan_skip != "sample":
            raise ValueError(
                "presence_dropout/presence_penalty are sample-granularity "
                "mitigations; they require nan_skip='sample' (batch mode is "
                "already presence-robust, 'none' never skips).")
    if presence_penalty and (shuffle or per_batch_seq or repeats):
        raise ValueError(STATIC_ORDER_MESSAGE)
    n_enc, n_dec = len(encoders), len(decoders)
    # The scan chain runs the first encoder's computation at every step.
    chain_encoders = [encoders[0]] * n_enc if chain == "scan" else encoders

    def batch_order(seq, perm, train):
        """The batch's (data_idx, enc_idx) pairs on a traced chain."""
        pairs = list(enumerate(int(e) for e in seq)) if per_batch_seq \
            else list(order)
        if shuffle and train:
            if perm is None:
                raise ValueError("shuffle takes each training batch's "
                                 "permutation of its pairs; got None")
            pairs = [pairs[int(i)] for i in perm]
        return pairs

    def cast(t):
        if torch.is_tensor(t) and t.is_floating_point():
            return t.to(compute_dtype)
        return t

    def loss_fn(params, data, targets, sample_mask, generator, init_offset,
                train: bool, drop=None, seq=None, perm=None,
                batch_stats=None):
        nan_any = None if batch_stats is None else batch_stats.nan_any
        if compute_dtype is not None:
            params = tree_map(cast, params)
            data = tuple(cast(x) for x in data)
        if presence_dropout and train:
            if drop is None:
                if generator is None:
                    raise ValueError("presence_dropout draws its mask from "
                                     "the training generator; got None")
                drop = draw_presence_dropout(
                    generator, sample_mask.shape[0], len(data),
                    presence_dropout, sample_mask.device)
            data = inject_presence_dropout(data, drop)
        if repeats:
            states, sc_x, ok_x, cnt_x, final_state = \
                forward_chain_executions(
                    encoders, init_state, params, data, sample_mask,
                    order=order, nan_skip=nan_skip, init_offset=init_offset,
                    train=train, generator=generator, nan_any=nan_any)
            exec_grid = decode_grid(decoders, params, states, targets,
                                    sample_mask, ok_x, criterion)
            grid = combine_executions(order, n_enc, exec_grid, sc_x, ok_x,
                                      cnt_x, exec_grid["outputs"])
            state_change, row_ok = grid["state_change"], grid["row_ok"]
            n_counted = grid["n_counted"]
        else:
            states, state_change, row_ok, n_counted, final_state = \
                forward_chain(
                    chain_encoders, init_state, params, data, sample_mask,
                    order=batch_order(seq, perm, train) if traced else order,
                    nan_skip=nan_skip, init_offset=init_offset, train=train,
                    generator=generator,
                    widths=switch_widths(encoders, data)
                    if chain == "switch" else None, nan_any=nan_any)
            grid = decode_grid(decoders, params, states, targets, sample_mask,
                               row_ok, criterion)
        global_err = grid["err_loss"].sum() / (n_dec * (n_enc + 1))
        global_sc = state_change.sum() / n_enc
        loss = global_err * err_penalty + global_sc * state_change_penalty
        if batch_stats is not None:
            loss = loss * batch_stats.scale
        if presence_penalty and train:
            loss = loss + presence_penalty * presence_penalty_term(
                states, data, sample_mask, order,
                None if batch_stats is None else batch_stats.axis)
        aux = {
            "enc_gates": row_ok[1:] if nan_skip == "batch" else None,
            "err_loss": grid["err_loss"],
            "state_change": state_change,
            "n_correct": grid["n_correct"],
            "tp": grid["tp"], "tn": grid["tn"],
            "fp": grid["fp"], "fn": grid["fn"],
            "n_counted": n_counted,
            "loss": loss,
            "global_err": global_err,
            "global_sc": global_sc,
            "final_outputs": [out[-1] for out in grid["outputs"]],
            "final_state": final_state,
            "all_outputs": grid["outputs"],
        }
        return loss, aux

    return loss_fn


def epoch_reduction(sums: dict, n_batches: int,
                    ones_initialized_counts: bool = True) -> dict:
    """Reduce an epoch's grid sums into the metrics the history stores.
    ``ones_initialized_counts`` keeps the reference's accuracy denominator
    starting at ones (``multimodn.py:105,270``, quirk #3)."""
    n_samples = sums["n_counted"][:, None]
    if ones_initialized_counts:
        n_samples = n_samples + 1.0
    sensitivity = safe_div(sums["tp"], sums["tp"] + sums["fn"])
    specificity = safe_div(sums["tn"], sums["tn"] + sums["fp"])
    return {
        "loss": sums["err_loss"] / n_batches,
        "state_change_loss": sums["state_change"] / n_batches,
        "accuracy": sums["n_correct"] / n_samples,
        "sensitivity": sensitivity,
        "specificity": specificity,
        "balanced_accuracy": (sensitivity + specificity) / 2.0,
        "n_samples": n_samples,
        "tp": sums["tp"], "tn": sums["tn"], "fp": sums["fp"],
        "fn": sums["fn"],
    }


def epoch_loss(host_sums: dict, n_batches: int) -> float:
    """An epoch's loss as a progress callback reports it: the mean of the
    (E+1, D) loss grid, each cell's sum over batches divided by
    ``n_batches`` (JAX ``core/step.py:706-707``)."""
    return float(host_sums["err_loss"].mean() / n_batches)


def gated_update(optimizer, grads, opt_state, params, enc_gates=None,
                 cross_rank=None):
    """Apply one optimizer step to ``params`` in place and return the new
    optimizer state. An optimizer with ``fused_apply`` writes the
    parameters itself (``Adam8bit``, through the fused Adam kernel on a
    CUDA model); otherwise its ``update`` is added to them. ``enc_gates``
    carries the per-encoder structural skip (``optim``); on a mesh they come
    from the global batch, so every rank gates alike. ``cross_rank``: on a
    mesh's model axis, ``(sharded-leaf flags, model axis)``, which the
    fused update needs for the per-row absmax of a sharded leaf; an
    elementwise update needs nothing.

    The JAX package can also skip a fully padded batch here, which its
    vmapped k-fold stacking makes; the port has no such batches, and a
    mesh's step skips the update when the global batch holds no real
    row (``parallel.dp_step``)."""
    fused = getattr(optimizer, "fused_apply", None)
    if fused is not None:
        kw = {} if cross_rank is None else {"cross_rank": cross_rank}
        return fused(grads, opt_state, params, enc_gates=enc_gates, **kw)
    updates, opt_state = optimizer.update(grads, opt_state, params,
                                          enc_gates=enc_gates)
    tree_map(lambda p, u: p.add_(u), params, updates)
    return opt_state


def to_host(tree):
    """A tree of float tensors copied to the host in one transfer (one
    wait for the device), as float32 CPU tensors of the same shapes."""
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    flat = torch.cat([t.detach().reshape(-1).float() for t in leaves]).cpu()
    pieces = torch.split(flat, [t.numel() for t in leaves])
    return tree_unflatten(tree, [p.reshape(t.shape)
                                 for p, t in zip(pieces, leaves)])


def stack_batches(stacks, counts: Sequence[int]):
    """``(batch, n_real)`` pairs over an ``ArrayLoader``'s device-resident
    epoch stacks: ``batch`` is ``(data tuple, targets, sample_mask)`` of
    batch ``b``, ``n_real`` its unpadded samples."""
    data, targets, mask = stacks
    for b, n_real in enumerate(counts):
        yield (tuple(d[b] for d in data), targets[b], mask[b]), n_real


def train_batch(loss_fn, optimizer, params, opt_state, batch, generator,
                offset: int, seq=None, perm=None, dp=None, n_real: int = 1):
    """One training step on one padded batch: the loss and its gradient
    with respect to every parameter leaf, then ``gated_update``. ``seq``
    and ``perm`` are the batch's encoder sequence and order permutation,
    when the loss takes them. On a mesh, ``dp`` (``parallel.dp_step.
    DataParallel``) runs the step on the rank's rows of the batch, with the
    global batch's ``n_real`` real rows. Returns ``(opt_state, aux)`` with
    ``aux`` detached."""
    if dp is not None:
        return dp.train_batch(loss_fn, optimizer, params, opt_state, batch,
                              generator, offset, n_real, seq=seq, perm=perm)
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    with span("step.forward"):
        loss, aux = loss_fn(live, *batch, generator, offset, True, seq=seq,
                            perm=perm)
    with span("step.backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
    with torch.no_grad(), span("step.optimizer"):
        opt_state = gated_update(optimizer, grads, opt_state, params,
                                 enc_gates=aux["enc_gates"])
    return opt_state, tree_map(lambda t: None if t is None else t.detach(),
                               aux)


def _grid_sums(ys: List[dict]) -> dict:
    return {k: torch.stack([y[k] for y in ys]).sum(dim=0) for k in GRID_KEYS}


def run_train_epoch(loss_fn, optimizer, params, opt_state, batches,
                    generator, offset: int, seqs=None, perms=None, dp=None):
    """Every ``(batch, n_real)`` of ``batches`` (``stack_batches`` or a
    streamed source) through ``train_batch``; batch ``b`` gets ``seqs[b]``
    and the ``b``-th permutation of the iterator ``perms`` when they are
    given. Returns ``(opt_state, sums, batch_log, offset, n_batches)``: the
    per-cell sums of ``GRID_KEYS``, an (n_batches, 3) tensor of (loss, grid
    mean, state change) per batch, all on the device, the init-state cycle
    offset advanced by the real samples, and the batches run. On a mesh
    (``dp``) the batches are the rank's rows, and the sums and the log are
    summed across the data axis once, at the end."""
    ys: List[dict] = []
    for b, (batch, n_real) in enumerate(batches):
        with span("train.step", rows=n_real):
            opt_state, aux = train_batch(
                loss_fn, optimizer, params, opt_state, batch, generator,
                offset, seq=None if seqs is None else seqs[b],
                perm=None if perms is None else next(perms), dp=dp,
                n_real=n_real)
            offset += n_real
            ys.append({k: aux[k] for k in GRID_KEYS + (
                "loss", "global_err", "global_sc")})
    batch_log = torch.stack([torch.stack([y["loss"], y["global_err"],
                                          y["global_sc"]]) for y in ys])
    sums = _grid_sums(ys)
    if dp is not None:
        sums, batch_log = dp.sum_grids(sums, batch_log)
    return opt_state, sums, batch_log, offset, len(ys)


@torch.no_grad()
def run_eval_epoch(loss_fn, params, batches, offset: int, seqs=None,
                   dp=None):
    """Every ``(batch, n_real)`` of ``batches`` in evaluation mode, batch
    ``b`` with ``seqs[b]`` when given. Returns ``(sums, final_outputs,
    targets, mask, offset, n_batches)``: the grid sums on the device; per
    decoder, the final-encoder-row outputs of every (padded) sample,
    ``(n_batches * B, C_d)``, which the performance suite and the selection
    score read (multimodn.py:354-357); the targets ``(n_batches * B, D)``
    and sample mask ``(n_batches * B,)`` in the same rows; the advanced
    offset and the batches run. On a mesh (``dp``) each rank evaluates its
    rows; the sums are summed across ranks and the outputs, targets and
    mask gathered back into the global order."""
    ys: List[dict] = []
    targets, masks = [], []
    full = None
    for b, (batch, n_real) in enumerate(batches):
        seq = None if seqs is None else seqs[b]
        if dp is None:
            _, aux = loss_fn(params, *batch, None, offset, False, seq=seq)
        else:
            aux = dp.eval_batch(loss_fn, params, batch, offset, seq=seq)
            full = batch.full
        offset += n_real
        ys.append({k: aux[k] for k in GRID_KEYS + ("final_outputs",)})
        targets.append(batch[1])
        masks.append(batch[2])
    outputs = [torch.cat([y["final_outputs"][d] for y in ys])
               for d in range(len(ys[0]["final_outputs"]))]
    sums, targets, masks = _grid_sums(ys), torch.cat(targets), \
        torch.cat(masks)
    if dp is not None:
        sums = dp.sum_grids(sums)
        outputs, targets, masks = (
            [dp.gather_rows(o, len(ys), full) for o in outputs],
            dp.gather_rows(targets, len(ys), full),
            dp.gather_rows(masks, len(ys), full))
    return sums, outputs, targets, masks, offset, len(ys)


def make_selection_score(binary_decoders: Sequence[bool]):
    """Per-epoch checkpoint-selection score: the sum over binary decoders of
    validation AUROC plus balanced accuracy on the final encoder row's
    epoch outputs, the reference MIMIC rule
    (``mimic_single_task_pipeline.py:141-158``). A NaN score becomes -inf,
    so a diverged epoch never wins."""

    def selection_score(outputs, val_targets, val_mask):
        flat_t = val_targets.reshape(-1, val_targets.shape[-1])
        flat_m = val_mask.reshape(-1).float()
        score = torch.zeros((), device=flat_m.device)
        for d, is_binary in enumerate(binary_decoders):
            if not is_binary:
                continue
            out = outputs[d]
            # Row-sum normalisation like the reference's test() (quirk #5),
            # with a sign-preserving guard against a zero sum.
            s = out.sum(dim=1, keepdim=True)
            norm = out / torch.where(s.abs() < 1e-12,
                                     torch.full_like(s, 1e-12), s)
            t = flat_t[:, d]
            auc = masked_binary_auroc(norm[:, 1], t, flat_m)
            pred = norm.argmax(dim=1)
            tp = (flat_m * ((pred == 1) & (t == 1))).sum()
            tn = (flat_m * ((pred == 0) & (t == 0))).sum()
            fp = (flat_m * ((pred == 1) & (t == 0))).sum()
            fn = (flat_m * ((pred == 0) & (t == 1))).sum()
            score = score + auc + (safe_div(tp, tp + fn)
                                   + safe_div(tn, tn + fp)) / 2.0
        return torch.where(torch.isnan(score),
                           torch.full_like(score, float("-inf")), score)

    return selection_score


def update_best(best: tuple, params: dict, score: float, epoch: int):
    """Strictly-greater best-checkpoint update (the reference's ``>`` at
    ``mimic_single_task_pipeline.py:149``). ``best`` is ``(params, score,
    epoch)``, starting at ``(copy, -inf, -1)``; returns ``(best,
    improved)``."""
    if score > best[1]:
        return (tree_map(torch.clone, params), score, epoch), True
    return best, False


def make_forward_fn(encoders, decoders, init_state,
                    order: Sequence[Tuple[int, int]], nan_skip: str,
                    chain: str = "unrolled"):
    """Return ``forward(params, data, sample_mask, init_offset=0) ->
    (preds (E+1, D, B) argmax classes, outputs list of (E+1, B, C_d),
    states (E+1, B, S), final_state (B, S))``.

    An order that repeats an encoder runs executions: each encoder's row
    takes its last live execution's state, and a row with none keeps the
    initial state (JAX ``core/step.py:1021-1036``); the scan chain refuses
    such an order. Every other order runs ``forward_chain``, with the switch
    chain's input fit on ``chain='switch'``."""
    repeats = has_repeated_encoders(order)
    if chain == "scan" and repeats:
        raise ValueError(REPEATS_NEED_UNROLLED)

    def forward(params, data, sample_mask, init_offset=0):
        if repeats:
            states_x, _, ok_x, _, final_state = forward_chain_executions(
                encoders, init_state, params, data, sample_mask,
                order=order, nan_skip=nan_skip, init_offset=init_offset)
            rows = [states_x[0]] * (len(encoders) + 1)
            for k, (_d, e) in enumerate(order):
                rows[e + 1] = torch.where(ok_x[k + 1] > 0, states_x[k + 1],
                                          rows[e + 1])
            states = torch.stack(rows)
        else:
            states, _, _, _, final_state = forward_chain(
                encoders, init_state, params, data, sample_mask,
                order=order, nan_skip=nan_skip, init_offset=init_offset,
                widths=switch_widths(encoders, data)
                if chain == "switch" else None)
        outputs = [dec.apply(params["decoders"][d], states)
                   for d, dec in enumerate(decoders)]
        preds = torch.stack([o.argmax(dim=-1) for o in outputs], dim=1)
        return preds, outputs, states, final_state

    return forward
