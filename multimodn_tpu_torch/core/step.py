"""Inference over one batch (PyTorch twin of
``multimodn_tpu/core/step.py::make_forward_fn``) on the unrolled chain.

PyTorch runs eagerly, so there is no program to compile and cache: the
returned function runs the chain and every decoder on each call. Training
programs come with a later slice (ROADMAP.md Queue A).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from multimodn_tpu_torch.core.fusion import forward_chain


def make_forward_fn(encoders, decoders, init_state,
                    order: Sequence[Tuple[int, int]], nan_skip: str,
                    chain: str = "unrolled"):
    """Return ``forward(params, data, sample_mask, init_offset=0) ->
    (preds (E+1, D, B) argmax classes, outputs list of (E+1, B, C_d),
    states (E+1, B, S), final_state (B, S))``."""
    if chain != "unrolled":
        raise NotImplementedError(
            f"chain={chain!r}: the scan and switch chains are not ported yet "
            "(ROADMAP.md Queue A, 'Encoding orders'); the unrolled chain "
            "gives the same results")

    def forward(params, data, sample_mask, init_offset=0):
        states, _, _, _, final_state = forward_chain(
            encoders, init_state, params, data, sample_mask,
            order=order, nan_skip=nan_skip, init_offset=init_offset)
        outputs = [dec.apply(params["decoders"][d], states)
                   for d, dec in enumerate(decoders)]
        preds = torch.stack([o.argmax(dim=-1) for o in outputs], dim=1)
        return preds, outputs, states, final_state

    return forward
