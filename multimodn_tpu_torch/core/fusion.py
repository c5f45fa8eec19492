"""The fusion core's forward pieces (PyTorch twin of the forward half of
``multimodn_tpu/core/fusion.py``).

A shared state vector threads through E per-modality encoders; after the
initial state and after every encoder step, each decoder reads the state,
which gives the ``(E+1) x D`` output grid. NaN missingness is a validity
mask with state passthrough:

- ``nan_skip='sample'``: only samples whose modality holds no NaN advance;
- ``nan_skip='batch'``: one NaN anywhere in the real batch skips the encoder
  for the whole batch (the reference's semantics);
- ``nan_skip='none'``: NaNs flow into the encoder (``predict``'s quirk #9).
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch


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
    nan_here = torch.isnan(x)
    sample_has_nan = nan_here.flatten(1).any(dim=1) if x.dim() > 1 \
        else nan_here
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
):
    """Run the encoder chain in ``order``, collecting per-row states.

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
            return _enc.apply(_p, _s, xv)

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
