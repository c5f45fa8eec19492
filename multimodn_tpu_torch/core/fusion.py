"""The fusion core (PyTorch twin of ``multimodn_tpu/core/fusion.py``).

A shared state vector threads through E per-modality encoders; after the
initial state and after every encoder step, each decoder reads the state,
which gives the ``(E+1) x D`` grid of outputs, losses and confusion counts.
NaN missingness is a validity mask with state passthrough:

- ``nan_skip='sample'``: only samples whose modality holds no NaN advance;
- ``nan_skip='batch'``: one NaN anywhere in the real batch skips the encoder
  for the whole batch (the reference's semantics);
- ``nan_skip='none'``: NaNs flow into the encoder (``predict``'s quirk #9).
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

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
                    nan_skip: str):
    """One encoder step's NaN-skip semantics. ``run(x)`` executes the encoder
    on the NaN-zeroed input. Returns ``(state, ok, counted)``: the state
    after the skip passthrough, the row-liveness scalar and the row's
    sample-count increment."""
    one = torch.ones((), device=x.device)
    if nan_skip == "none":
        return run(x), one, n_real
    sample_has_nan = sample_missing(x)
    new_state = run(torch.nan_to_num(x))
    if nan_skip == "batch":
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
):
    """Run the encoder chain in ``order``, collecting per-row states.
    ``train`` turns on the encoders' dropout, drawn from ``generator``.

    Returns:
        states_by_row: (E+1, B, S) — row 0 is the initial state, row e+1 the
            state right after encoder e ran; never-executed rows repeat the
            initial state.
        state_change: (E,) masked mean squared state deltas per encoder row.
        row_ok: (E+1,) 1.0 where the row's grid cells are live this batch.
        n_counted: (E+1,) per-row sample-count increments.
        final_state: the state after the last executed step.
    """
    if has_repeated_encoders(order):
        raise NotImplementedError(
            "orders that repeat an encoder are not ported yet "
            "(ROADMAP.md Queue A, 'Encoding orders')")
    n_enc = len(encoders)
    batch = sample_mask.shape[0]
    zero = torch.zeros((), device=sample_mask.device)
    n_real = sample_mask.float().sum()

    state = init_chain_state(init_state, params, batch, init_offset, data)
    states_rows: List = [state] * (n_enc + 1)
    state_change = [zero] * n_enc
    row_ok = [zero + 1.0] + [zero] * n_enc
    n_counted = [n_real] + [zero] * n_enc

    for data_idx, enc_idx in order:
        enc = encoders[enc_idx]
        old_state = state

        def run(xv, _p=params["encoders"][enc_idx], _s=state, _enc=enc):
            return _enc.apply(_p, _s, xv, train=train, generator=generator)

        state, ok, counted = chain_step_skip(
            run, data[data_idx], old_state, sample_mask, n_real,
            nan_skip=nan_skip)
        states_rows[enc_idx + 1] = state
        state_change[enc_idx] = masked_mean_sq_diff(state, old_state,
                                                    sample_mask)
        row_ok[enc_idx + 1] = ok
        n_counted[enc_idx + 1] = counted

    return (torch.stack(states_rows), torch.stack(state_change),
            torch.stack(row_ok), torch.stack(n_counted), state)


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
