"""Serving: step-at-a-time fusion and the portable export format (PyTorch
twin of ``multimodn_tpu/serving.py``).

``InferenceSession`` advances the state one modality at a time and reads
every decoder after each step. ``export_model`` / ``load_model`` write and
read the JAX package's format, ``config.json`` + ``params.npz``, so a model
exported by either package loads in the other. It rebuilds the MLP-family,
SLP, recurrent and attention encoders and the dense decoders; ahead-of-time
compiled exports come later (ROADMAP.md Queue A, 'Serving').
"""
from __future__ import annotations

import inspect
import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from multimodn_tpu_torch import decoders as dec_mod
from multimodn_tpu_torch import encoders as enc_mod
from multimodn_tpu_torch.core.nn import activation_name
from multimodn_tpu_torch.core.state import StaticInitState
from multimodn_tpu_torch.model import MultiModN

STATIC_BANK_KEY = "__static_init_state_bank__"


class InferenceSession:
    """Step-at-a-time fusion over a MultiModN. Parameters are read from the
    model on every call, so a session always serves the model's current
    weights."""

    def __init__(self, model: MultiModN):
        self.model = model

    def init(self, batch_size: int) -> torch.Tensor:
        """Initial (batch, state_size) state. StaticInitState sessions start
        at cycle phase 0: each session is its own stream and leaves the
        model's cycle counter alone."""
        return self.model.init_state.apply(
            self.model.params["init_state"], batch_size, 0)

    def _decode(self, state) -> List[np.ndarray]:
        return [dec.apply(self.model.params["decoders"][d], state)
                .cpu().numpy() for d, dec in enumerate(self.model.decoders)]

    @torch.no_grad()
    def step(self, state, encoder_idx: int, x,
             nan_skip: Optional[bool] = None
             ) -> Tuple[torch.Tensor, List[np.ndarray]]:
        """Advance the state with one modality; return (state, per-decoder
        probabilities for the updated state).

        ``nan_skip`` defaults to the model's mode ('sample': NaN rows keep
        their state; 'batch': one NaN row skips the step for the whole
        batch; 'none': no skip); an explicit bool overrides it (True =
        per-sample, False = no skip). NaNs are zero-filled before the
        encoder runs in every mode."""
        mode = self.model.nan_skip if nan_skip is None \
            else ("sample" if nan_skip else "none")
        x = self.model._to_device([x])[0]
        params = self.model.params["encoders"][encoder_idx]
        new_state = self.model.encoders[encoder_idx].apply(
            params, state, torch.nan_to_num(x))
        if mode == "sample":
            has_nan = torch.isnan(x).flatten(1).any(dim=1)
            new_state = torch.where(has_nan[:, None], state, new_state)
        elif mode == "batch":
            new_state = torch.where(torch.isnan(x).any(), state, new_state)
        return new_state, self._decode(new_state)

    @torch.no_grad()
    def decode(self, state) -> List[np.ndarray]:
        """Per-decoder probabilities for the current state."""
        return self._decode(state)


# ---------------------------------------------------------------------------
# Pickle-free export / load, in the JAX package's format
# ---------------------------------------------------------------------------

def _flatten_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten_with_paths(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _unflatten(flat: dict) -> dict:
    """Inverse of ``_flatten_with_paths``: nested dicts, with every dict
    whose keys are all digits turned back into a list."""
    root: dict = {}
    for path, value in flat.items():
        node = root
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def _module_spec(m) -> dict:
    spec = {"class": type(m).__name__}
    for attr in ("state_size", "n_features", "hidden_layers", "dropout_rate",
                 "n_classes", "unbatched_compat", "embed_dim", "n_heads",
                 "n_layers", "mlp_ratio", "chunk",
                 # ViTEncoder's geometry, without which it would be rebuilt
                 # for its constructor's default (32, 32) images.
                 "image_size", "patch_size", "channels"):
        if hasattr(m, attr):
            v = getattr(m, attr)
            spec[attr] = list(v) if isinstance(v, tuple) else v
    for attr in ("activation", "hidden_activation", "output_activation"):
        fn = getattr(m, attr, None)
        if fn is not None:
            spec[attr] = activation_name(fn)
    return spec


def export_model(model: MultiModN, directory: str) -> str:
    """Write config.json + params.npz: an artifact that loads without
    unpickling code, in this package or the JAX one."""
    os.makedirs(directory, exist_ok=True)
    static = isinstance(model.init_state, StaticInitState)
    config = {
        "state_size": model.state_size,
        "err_penalty": model.err_penalty,
        # The constructor re-applies the 0.01 factor (quirk #1).
        "state_change_penalty": model.state_change_penalty / 0.01,
        "nan_skip": model.nan_skip,
        # The JAX package reads per-encoder parameter storage under any
        # chain_mode (it stacks them itself for its scan chain).
        "chain_mode": model.chain_mode,
        "shuffle_mode": model.shuffle_mode,
        "ones_initialized_counts": model.ones_initialized_counts,
        "presence_penalty": model.presence_penalty,
        "presence_dropout": model.presence_dropout,
        "compute_dtype": None,
        "scan_unroll": model.scan_unroll,
        "seed": model._seed,
        "encoders": [_module_spec(e) for e in model.encoders],
        "decoders": [_module_spec(d) for d in model.decoders],
        "static_init_state": static,
    }
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    # The JAX package reads an artifact into its own storage, stacked for a
    # scan-planned model.
    flat = dict(_flatten_with_paths(model._jax_storage()))
    if static:
        flat[STATIC_BANK_KEY] = model.init_state.bank()
    np.savez(os.path.join(directory, "params.npz"), **flat)
    return directory


def _build(spec: dict, registry, kind: str):
    cls = getattr(registry, spec["class"], None)
    if cls is None:
        raise NotImplementedError(
            f"{kind} class {spec['class']!r} is not ported yet; this package "
            f"rebuilds {', '.join(registry.__all__)} (ROADMAP.md Queue A)")
    kwargs = {}
    for name in inspect.signature(cls.__init__).parameters:
        if name == "self":
            continue
        if name == "hidden_size":
            # Feature-encoder constructors take a scalar hidden width; the
            # export keeps the expanded hidden_layers tuple.
            v = spec.get("hidden_layers")
            if v:
                kwargs[name] = int(v[0]) if isinstance(v, (list, tuple)) \
                    else int(v)
            continue
        key = {"dropout": "dropout_rate"}.get(name, name)
        if key in spec:
            v = spec[key]
            kwargs[name] = tuple(v) if isinstance(v, list) else v
    return cls(**kwargs)


def load_model(directory: str, device=None) -> MultiModN:
    """Rebuild a MultiModN from an ``export_model`` artifact of either
    package, on ``device`` (CUDA unless the caller names another)."""
    with open(os.path.join(directory, "config.json")) as f:
        config = json.load(f)
    if config.get("compute_dtype") not in (None, "float32"):
        raise NotImplementedError(
            f"compute_dtype={config['compute_dtype']!r}: mixed precision is "
            "not ported yet (ROADMAP.md Queue A, 'Mixed precision')")
    encoders = [_build(s, enc_mod, "encoder") for s in config["encoders"]]
    decoders = [_build(s, dec_mod, "decoder") for s in config["decoders"]]
    with np.load(os.path.join(directory, "params.npz")) as npz:
        flat = dict(npz)
    init_state = None
    if config.get("static_init_state", False):
        bank = flat.pop(STATIC_BANK_KEY, None)
        if bank is None:
            raise ValueError(
                f"{directory}: config says static_init_state but params.npz "
                "has no state bank")
        init_state = StaticInitState(list(bank))
    model = MultiModN(
        config["state_size"], encoders, decoders,
        config["err_penalty"], config["state_change_penalty"],
        shuffle_mode=config.get("shuffle_mode", False),
        init_state=init_state,
        nan_skip=config.get("nan_skip", "sample"),
        ones_initialized_counts=config.get("ones_initialized_counts", True),
        seed=config.get("seed", 0),
        presence_dropout=config.get("presence_dropout", 0.0),
        presence_penalty=config.get("presence_penalty", 0.0),
        chain_mode=config.get("chain_mode", "auto"),
        scan_unroll=config.get("scan_unroll"),
        device=device,
    )
    model.load_state_dict(_unflatten(flat))
    return model
