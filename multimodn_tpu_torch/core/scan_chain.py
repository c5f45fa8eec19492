"""The traced-order chains (PyTorch twin of ``multimodn_tpu/core/scan_chain.py``).

The JAX package compiles a chain whose encoder order is data, not program
structure, in two forms: ``forward_chain_scan``, one ``lax.scan`` step over
stacked parameters for structurally identical encoders, and
``forward_chain_switch``, a ``lax.switch`` over the encoders for mixed ones,
whose inputs are zero-padded to the widest modality and cut to the
encoder's width. They serve ``shuffle_mode`` (a fresh order per training
batch, reference ``multimodn.py:527-529``) and per-batch encoding sequences
without a new program per order.

PyTorch runs eagerly, so an order is just a list, and both chains are
``fusion.forward_chain`` on the batch's ``(data_idx, enc_idx)`` pairs, whose
row mapping is the traced chains' own: the last execution of an encoder
writes its row, and a row that never executed carries the initial state
(JAX ``_scatter_rows``), and a mask-aware encoder gets the unrolled
chain's effective sample mask (JAX ``scan_chain.py:107``, ``:211-225``).
The two names below serve callers of the JAX package's function-level
API. Parameters stay in per-encoder storage; ``convert`` unstacks the JAX
package's stacked trees.
"""
from __future__ import annotations

from typing import Sequence

from multimodn_tpu_torch.core.fusion import forward_chain, switch_widths

# Attributes that must agree for encoders to share one scan step: those
# that shape the parameters and those that change the computation only.
HOMOGENEOUS_ATTRS = ("_layer_dims", "_dims", "hidden_layers", "n_features",
                     "state_size", "dropout_rate", "unbatched_compat",
                     "n_heads", "embed_dim", "n_layers", "mlp_ratio",
                     "chunk", "freeze")


def encoders_homogeneous(encoders: Sequence) -> bool:
    """True when every encoder shares the first's class, dims, activation
    and every other config attribute of ``HOMOGENEOUS_ATTRS``."""
    if len(encoders) < 1:
        return False
    first = encoders[0]
    for enc in encoders[1:]:
        if type(enc) is not type(first):
            return False
        for attr in HOMOGENEOUS_ATTRS:
            if getattr(enc, attr, None) != getattr(first, attr, None):
                return False
        if getattr(enc, "activation", None) is not \
                getattr(first, "activation", None):
            return False
    return True


def forward_chain_scan(encoder, n_encoders: int, init_state, params: dict,
                       data, sample_mask, *, data_order, enc_order, **kw):
    """The scan chain: ``encoder``'s computation with encoder
    ``enc_order[k]``'s parameters on modality ``data_order[k]`` at step k;
    ``kw`` and the result as ``fusion.forward_chain``'s."""
    return forward_chain([encoder] * n_encoders, init_state, params, data,
                         sample_mask, order=list(zip(data_order, enc_order)),
                         **kw)


def forward_chain_switch(encoders, init_state, params: dict, data,
                         sample_mask, *, data_order, enc_order, **kw):
    """The switch chain for mixed encoders: each input zero-padded to the
    widest modality and cut to its encoder's width (``switch_widths``), so
    any pairing of equal widths runs; otherwise as ``forward_chain_scan``."""
    return forward_chain(encoders, init_state, params, data, sample_mask,
                         order=list(zip(data_order, enc_order)),
                         widths=switch_widths(encoders, data), **kw)
