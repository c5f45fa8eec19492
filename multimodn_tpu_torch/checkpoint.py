"""Checkpoint files (``save_checkpoint`` / ``load_checkpoint`` of
``multimodn_tpu/checkpoint.py``).

A checkpoint is a pickle of numpy trees with the reference's best-model
payload keys (``{'epoch', 'model_state_dict', 'auc_bac_val_cum'}``,
``mimic_single_task_pipeline.py:151-158``), plus the optimizer state when
asked. The JAX package writes the same payload, so a file written by either
package loads in the other. Writes are atomic (a tmp file, then
``os.replace``).
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import torch

from multimodn_tpu_torch.core.tree import tree_map


def _to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if torch.is_tensor(t) else t, tree)


def _atomic_pickle(path: str, payload: dict):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


def save_checkpoint(path: str, model, epoch: int,
                    score: Optional[float] = None,
                    include_opt_state: bool = False,
                    extra: Optional[dict] = None) -> str:
    """Write ``model``'s parameters (a ``MultiModN`` or ``HAIM``) with the
    epoch and validation score; returns ``path``."""
    payload = {
        "epoch": epoch,
        "model_state_dict": _to_numpy(model.params),
        "auc_bac_val_cum": score,
    }
    if include_opt_state and getattr(model, "opt_state", None) is not None:
        payload["opt_state"] = _to_numpy(model.opt_state)
    if extra:
        payload.update(extra)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _atomic_pickle(path, payload)
    return path


def load_checkpoint(path: str, model=None) -> dict:
    """The payload; with ``model``, its parameters are loaded too."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if model is not None:
        model.load_state_dict(payload["model_state_dict"])
    return payload
