"""The fusion core (PyTorch twin of ``multimodn_tpu/core/fusion.py``).

A shared state vector threads through E per-modality encoders; after the
initial state and after every encoder step, each decoder reads the state,
which gives the ``(E+1) x D`` grid of outputs, losses and confusion counts.
NaN missingness is a validity mask with state passthrough:

- ``nan_skip='sample'``: only samples whose modality holds no NaN advance;
- ``nan_skip='batch'``: one NaN anywhere in the real batch skips the encoder
  for the whole batch (the reference's semantics); on a mesh the batch is
  the GLOBAL one, whose any-NaN flags arrive as ``nan_any`` (one per
  modality, ``parallel.dp_step``), as JAX's ``global_any`` makes them;
- ``nan_skip='none'``: NaNs flow into the encoder (``predict``'s quirk #9).

Every chain form is one Python loop over ``(data_idx, enc_idx)`` pairs
(``run_executions``); the forms differ only in how executions map to metric
rows: the last execution of an encoder wins (``forward_chain``, which also
runs the traced chains of ``core/scan_chain.py``), or, for a static order that
repeats an encoder, executions are decoded one by one and combined
(``forward_chain_executions`` + ``combine_executions``).
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F

from multimodn_tpu_torch.core.metrics import binary_confusion_counts


def default_order(n_encoders: int) -> Tuple[Tuple[int, int], ...]:
    """Identity (data_idx, enc_idx) pairing."""
    return tuple((i, i) for i in range(n_encoders))


def has_repeated_encoders(order) -> bool:
    """True when an encoder id appears more than once in an order."""
    encs = [int(e) for _d, e in order]
    return len(set(encs)) < len(encs)


def masked_mean_sq_diff(new_state, old_state, sample_mask):
    """Mean over (valid samples x features) of the squared state delta,
    in float32."""
    diff = new_state.float() - old_state.float()
    per_sample = (diff ** 2).mean(dim=-1)
    m = sample_mask.to(per_sample.dtype)
    return (per_sample * m).sum() / m.sum().clamp_min(1.0)


def sample_missing(x: torch.Tensor) -> torch.Tensor:
    """(B,) True where a sample's modality input holds a NaN."""
    nan_here = torch.isnan(x)
    return nan_here.flatten(1).any(dim=1) if x.dim() > 1 else nan_here


def init_chain_state(init_state, params: dict, batch: int, init_offset,
                     data) -> torch.Tensor:
    """Initial state for a chain run, dtype-aligned with the modality data."""
    state = init_state.apply(params["init_state"], batch, init_offset)
    return state.to(data[0].dtype)


def chain_step_skip(run: Callable, x, old_state, sample_mask, n_real, *,
                    nan_skip: str, mask_aware: bool = False, any_nan=None):
    """One encoder step's NaN-skip semantics. ``run(x, eff_mask)`` executes
    the encoder on the NaN-zeroed input. A mask-aware encoder (one with
    ``_accepts_sample_mask``, whose batch statistics must see only real,
    present rows: ResNet's BatchNorm) gets ``eff_mask``, the sample mask
    with the rows whose modality holds a NaN dropped (the sample mask
    itself under ``nan_skip='none'``); any other encoder gets None (JAX
    ``core/fusion.py:107-160``). Returns ``(state, ok, counted)``: the
    state after the skip passthrough, the row-liveness scalar and the
    row's sample-count increment."""
    one = torch.ones((), device=x.device)
    if nan_skip == "none":
        return run(x, sample_mask if mask_aware else None), one, n_real
    sample_has_nan = sample_missing(x)
    eff_mask = sample_mask * (~sample_has_nan).to(sample_mask.dtype) \
        if mask_aware else None
    new_state = run(torch.nan_to_num(x), eff_mask)
    if nan_skip == "batch":
        if any_nan is None:
            any_nan = (sample_has_nan & (sample_mask > 0)).any()
        ok = torch.where(any_nan, 0.0, 1.0).to(one)
        state = torch.where(any_nan, old_state, new_state)
        counted = n_real * ok
    elif nan_skip == "sample":
        valid = (~sample_has_nan) & (sample_mask > 0)
        state = torch.where(valid[:, None], new_state, old_state)
        ok = one
        counted = n_real
    else:
        raise ValueError(f"Unknown nan_skip mode {nan_skip!r}")
    return state, ok, counted


def switch_widths(encoders, data):
    """The switch chain's ``(fmax, per-encoder input widths)``: the widest
    modality, and each encoder's ``n_features`` (modality j's width for an
    encoder without one)."""
    fmax = max(x.shape[-1] for x in data)
    return fmax, [getattr(enc, "n_features", None) or data[j].shape[-1]
                  for j, enc in enumerate(encoders)]


def _fit_width(x: torch.Tensor, fmax: int, width: int) -> torch.Tensor:
    """The switch chain's input: ``x`` zero-padded along its last axis to
    the widest modality ``fmax``, then cut to the encoder's ``width``; an
    input of the encoder's width already passes unchanged."""
    if x.shape[-1] == width:
        return x
    x = F.pad(x, (0, fmax - x.shape[-1]))
    return x[..., :width]


def run_executions(encoders, init_state, params, data, sample_mask, *,
                   order, nan_skip, init_offset=0, train=False,
                   generator=None, widths=None, nan_any=None):
    """Run the encoders in ``order``, one execution per ``(data_idx,
    enc_idx)`` pair: the loop every chain form shares. ``train`` turns on
    the encoders' dropout, drawn from ``generator``; a mask-aware encoder
    also gets each step's effective sample mask (``chain_step_skip``).
    ``widths`` is the switch chain's ``(fmax, per-encoder input widths)``
    (``switch_widths``): each input is then zero-padded to ``fmax`` and cut
    to its encoder's width. ``nan_any``: the global per-modality any-NaN
    flags of a mesh's batch (``chain_step_skip``).

    Returns ``(state0, states, state_change, ok, counted, n_real)``: the
    initial state and, per execution, its state after the skip
    passthrough, masked mean squared state delta, liveness and
    sample-count increment."""
    n_real = sample_mask.float().sum()
    state = init_chain_state(init_state, params, sample_mask.shape[0],
                             init_offset, data)
    state0 = state
    states, sc, ok_exec, counted_exec = [], [], [], []
    for data_idx, enc_idx in order:
        data_idx, enc_idx = int(data_idx), int(enc_idx)
        enc = encoders[enc_idx]
        old_state = state

        mask_aware = getattr(enc, "_accepts_sample_mask", False)

        def run(xv, eff_mask, _p=params["encoders"][enc_idx], _s=state,
                _enc=enc, _aware=mask_aware,
                _w=None if widths is None else widths[1][enc_idx]):
            if _w is not None:
                xv = _fit_width(xv, widths[0], _w)
            kw = {"sample_mask": eff_mask} if _aware else {}
            return _enc.apply(_p, _s, xv, train=train, generator=generator,
                              **kw)

        state, ok, counted = chain_step_skip(
            run, data[data_idx], old_state, sample_mask, n_real,
            nan_skip=nan_skip, mask_aware=mask_aware,
            any_nan=None if nan_any is None else nan_any[data_idx])
        states.append(state)
        sc.append(masked_mean_sq_diff(state, old_state, sample_mask))
        ok_exec.append(ok)
        counted_exec.append(counted)
    return state0, states, sc, ok_exec, counted_exec, n_real


def rows_by_last_execution(n_enc: int, order, state0, states, sc, ok,
                           counted, n_real):
    """Executions -> metric rows (row ``e + 1`` for encoder ``e``), the
    last execution of each encoder winning; a row that never executed
    carries the initial state with zero change, liveness and count. This
    is the unrolled chain's overwrite and the JAX traced chains'
    ``_scatter_rows`` (``core/scan_chain.py:143-166``); it is not
    ``combine_executions``' rule."""
    zero = torch.zeros((), device=n_real.device)
    rows = [state0] * (n_enc + 1)
    state_change = [zero] * n_enc
    row_ok = [zero + 1.0] + [zero] * n_enc
    n_counted = [n_real] + [zero] * n_enc
    for k, (_d, e) in enumerate(order):
        e = int(e)
        rows[e + 1] = states[k]
        state_change[e] = sc[k]
        row_ok[e + 1] = ok[k]
        n_counted[e + 1] = counted[k]
    final = states[-1] if states else state0
    return (torch.stack(rows), torch.stack(state_change),
            torch.stack(row_ok), torch.stack(n_counted), final)


def forward_chain(
    encoders: Sequence,
    init_state,
    params: dict,
    data: Sequence[torch.Tensor],
    sample_mask: torch.Tensor,
    *,
    order: Sequence[Tuple[int, int]],
    nan_skip: str = "sample",
    init_offset: int = 0,
    train: bool = False,
    generator=None,
    widths=None,
    nan_any=None,
):
    """Run the encoder chain in ``order``, collecting per-row states.
    ``train`` turns on the encoders' dropout, drawn from ``generator``.
    ``widths``: the switch chain's input fit, ``nan_any`` a mesh batch's
    global NaN flags (``run_executions``).

    Returns:
        states_by_row: (E+1, B, S) — row 0 is the initial state, row e+1 the
            state after encoder e's last execution; never-executed rows
            repeat the initial state.
        state_change: (E,) masked mean squared state deltas per encoder row.
        row_ok: (E+1,) 1.0 where the row's grid cells are live this batch.
        n_counted: (E+1,) per-row sample-count increments.
        final_state: the state after the last executed step.
    """
    state0, *executions = run_executions(
        encoders, init_state, params, data, sample_mask, order=order,
        nan_skip=nan_skip, init_offset=init_offset, train=train,
        generator=generator, widths=widths, nan_any=nan_any)
    return rows_by_last_execution(len(encoders), order, state0, *executions)


def forward_chain_executions(encoders, init_state, params, data,
                             sample_mask, *, order, nan_skip="sample",
                             init_offset=0, train=False, generator=None,
                             nan_any=None):
    """``forward_chain`` for orders that repeat an encoder: row k+1 is the
    state after the k-th EXECUTION, whatever encoder it ran;
    ``combine_executions`` folds the decoded grid back into encoder rows.

    Returns ``(states (K+1, B, S), state_change (K,), ok (K+1,), counted
    (K+1,), final_state)``."""
    state0, states, sc, ok, counted, n_real = run_executions(
        encoders, init_state, params, data, sample_mask, order=order,
        nan_skip=nan_skip, init_offset=init_offset, train=train,
        generator=generator, nan_any=nan_any)
    one = torch.ones((), device=n_real.device)
    return (torch.stack([state0] + states),
            torch.stack(sc) if sc else torch.zeros((0,), device=one.device),
            torch.stack([one] + ok), torch.stack([n_real] + counted),
            states[-1] if states else state0)


def combine_executions(order, n_enc: int, exec_grid: dict, sc_exec, ok_exec,
                       cnt_exec, exec_outputs) -> dict:
    """Fold an execution-indexed grid into the reference's encoder-indexed
    ``(E+1, D)`` grid for orders that repeat an encoder
    (``multimodn.py:171-192``; JAX ``core/fusion.py:302-357``):

    - ``n_correct``, the confusion cells and ``n_counted`` accumulate over
      the row's executions (a skipped execution adds its zeroed cells);
    - ``err_loss``, the row's decoder outputs and ``state_change`` take the
      last NON-SKIPPED execution's value;
    - a row is live if any of its executions ran.
    Rows that never ran hold zeros."""
    err0 = exec_grid["err_loss"]
    zeros = err0.new_zeros(err0.shape[1])
    zero = err0.new_zeros(())
    err = [err0[0]] + [zeros] * n_enc
    ncorr = [exec_grid["n_correct"][0]] + [zeros] * n_enc
    conf = {k: [exec_grid[k][0]] + [zeros] * n_enc
            for k in ("tp", "tn", "fp", "fn")}
    n_counted = [cnt_exec[0]] + [zero] * n_enc
    row_ok = [zero + 1.0] + [zero] * n_enc
    state_change = [zero] * n_enc
    outputs = [[o[0]] + [torch.zeros_like(o[0])] * n_enc
               for o in exec_outputs]
    for k, (_d, e) in enumerate(order):
        e = int(e)
        r, x = e + 1, k + 1
        live = ok_exec[x] > 0
        err[r] = torch.where(live, err0[x], err[r])
        ncorr[r] = ncorr[r] + exec_grid["n_correct"][x]
        for key, rows in conf.items():
            # NaN columns (non-binary decoders) stay NaN under addition.
            rows[r] = rows[r] + exec_grid[key][x]
        n_counted[r] = n_counted[r] + cnt_exec[x]
        row_ok[r] = torch.maximum(row_ok[r], ok_exec[x])
        state_change[e] = torch.where(live, sc_exec[k], state_change[e])
        for rows, eo in zip(outputs, exec_outputs):
            rows[r] = torch.where(live, eo[x], rows[r])
    combined = {"err_loss": torch.stack(err),
                "n_correct": torch.stack(ncorr),
                "n_counted": torch.stack(n_counted),
                "row_ok": torch.stack(row_ok),
                "state_change": torch.stack(state_change),
                "outputs": [torch.stack(rows) for rows in outputs]}
    combined.update({k: torch.stack(v) for k, v in conf.items()})
    return combined


def decode_grid(decoders: Sequence, params: dict, states_by_row, targets,
                sample_mask, row_ok, criterion: Callable) -> dict:
    """Evaluate every decoder on every state row and emit the per-cell
    statistics.

    Args:
        states_by_row: (E+1, B, S).
        targets: (B, D) integer labels.
        sample_mask: (B,).
        row_ok: (E+1,) row liveness; a dead row's cells stay 0, as the
            reference leaves them (multimodn.py:123,167).
    Returns a dict of (E+1, D) grids ``err_loss``, ``n_correct``, ``tp``,
    ``tn``, ``fp``, ``fn`` (NaN columns for non-binary decoders, like the
    reference's ``compute_metrics``) and ``outputs``, the list of D
    (E+1, B, C_d) decoder outputs.
    """
    n_rows = states_by_row.shape[0]
    row_mask = row_ok[:, None] * sample_mask.float()[None, :]   # (E+1, B)
    cols = {k: [] for k in ("err_loss", "n_correct", "tp", "tn", "fp", "fn")}
    outputs = []
    for d, dec in enumerate(decoders):
        out = dec.apply(params["decoders"][d], states_by_row).float()
        outputs.append(out)
        tgt = targets[:, d][None, :].expand(n_rows, targets.shape[0])
        if criterion_accepts_mask(criterion):
            ce = criterion(out, tgt, row_mask)
        else:
            # A 2-argument criterion reduces one (B, C) batch to a scalar;
            # apply it to each metric row.
            ce = torch.stack([torch.as_tensor(criterion(out[r], tgt[r]))
                              for r in range(n_rows)])
        if tuple(ce.shape) != (n_rows,):
            raise ValueError(
                f"criterion must reduce each (B, C) row to a scalar; got "
                f"shape {tuple(ce.shape)} for {n_rows} rows")
        cols["err_loss"].append(ce * row_ok)
        pred = out.argmax(dim=-1)
        cols["n_correct"].append(((pred == tgt).float() * row_mask).sum(-1))
        if dec.n_classes == 2:
            counts = binary_confusion_counts(pred, tgt, row_mask)
        else:
            counts = (torch.full((n_rows,), float("nan"),
                                 device=out.device),) * 4
        for k, c in zip(("tp", "tn", "fp", "fn"), counts):
            cols[k].append(c)
    grid = {k: torch.stack(v, dim=1) for k, v in cols.items()}
    grid["outputs"] = outputs
    return grid


def criterion_accepts_mask(criterion) -> bool:
    """Built-in losses take (outputs, targets, mask); user callables may
    not."""
    return getattr(criterion, "_accepts_mask", True)
