"""Serving: step-at-a-time fusion and the portable export format (PyTorch
twin of ``multimodn_tpu/serving.py``).

``InferenceSession`` advances the state one modality at a time and reads
every decoder after each step. ``export_model`` / ``load_model`` write and
read the JAX package's format, ``config.json`` + ``params.npz``, so a model
exported by either package loads in the other. It rebuilds the MLP-family,
SLP, recurrent, attention and ResNet encoders, the dense decoders and the
model's ``compute_dtype``.
``export_compiled`` / ``load_compiled`` write and serve an ahead-of-time
artifact: the model's whole forward with its parameters inside, a
``torch.export`` program (``.pt2``) that loads without this package.
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
from multimodn_tpu_torch.convert import params_from_jax
from multimodn_tpu_torch.core.nn import activation_name, dtype_name, \
    resolve_device
from multimodn_tpu_torch.core.state import StaticInitState
from multimodn_tpu_torch.core.step import make_forward_fn
from multimodn_tpu_torch.core.tree import tree_leaves, tree_unflatten
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
            self.model._whole_params()["init_state"], batch_size, 0)

    def _decode(self, state) -> List[np.ndarray]:
        params = self.model._whole_params()
        return [dec.apply(params["decoders"][d], state)
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
        params = self.model._whole_params()["encoders"][encoder_idx]
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
                 "n_layers", "mlp_ratio", "chunk", "freeze",
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
        "compute_dtype": dtype_name(model.compute_dtype),
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
            f"{kind} class {spec['class']!r} is not one this package "
            f"rebuilds: {', '.join(registry.__all__)}")
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
        compute_dtype=config.get("compute_dtype"),
    )
    model.load_state_dict(_unflatten(flat))
    return model


# ---------------------------------------------------------------------------
# Ahead-of-time artifacts: torch.export programs
# ---------------------------------------------------------------------------

class _CompiledForward(torch.nn.Module):
    """The forward an artifact computes, with the parameter leaves as
    buffers, so ``torch.export`` saves them inside the program."""

    def __init__(self, forward, params: dict):
        super().__init__()
        self._forward = forward
        self._like = params
        leaves = tree_leaves(params)
        self._n_leaves = len(leaves)
        for i, leaf in enumerate(leaves):
            self.register_buffer(f"leaf{i}", leaf)

    def forward(self, *modalities):
        params = tree_unflatten(self._like, [
            getattr(self, f"leaf{i}") for i in range(self._n_leaves)])
        mask = torch.ones(modalities[0].shape[0],
                          device=modalities[0].device)
        return tuple(self._forward(params, modalities, mask)[1])


def _drop_noop_casts(program):
    """Remove the exported graph's casts to the dtype a tensor already has
    (``dense_apply`` casts to the compute dtype, float32 here) and their
    metadata asserts: in an exported program each is a host dispatch per
    call, about half of the MIMIC forward's operations."""
    graph = program.graph_module.graph
    ops = torch.ops.aten
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is ops._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif node.target is ops.to.dtype and len(node.args) == 2 and \
                not node.kwargs and \
                node.args[0].meta["val"].dtype == node.args[1]:
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    graph.eliminate_dead_code()
    program.graph_module.recompile()
    return program


# torch.export specialises a batch of 0 or 1; an example of 2 rows keeps
# the batch dimension symbolic, and the artifact serves any b >= 1.
_EXAMPLE_BATCH = 2


def export_compiled(model: MultiModN, path: str,
                    platforms=("cpu", "cuda"), encoder_sequence=None) -> str:
    """Write the model's whole forward as an ahead-of-time artifact at
    ``path``: a ``torch.export`` program (``torch.export.save``, a
    ``.pt2`` archive) with the parameters inside and a symbolic batch
    dimension, traced on the CPU whatever the model's device.

    The artifact takes one ``(b, F)`` float32 array per modality, in the
    order of the resolved ``(modality, encoder)`` pairing of
    ``encoder_sequence`` (the identity by default): modality ``d`` has the
    width of the encoder paired with it. It returns every decoder's raw
    outputs after every step, ``(E+1, b, C_d)`` per decoder, under the
    model's own ``nan_skip`` (the serving semantics; ``predict_proba``
    does not skip, quirk #9). A ``StaticInitState`` model is exported at
    cycle phase 0.

    ``platforms`` keeps the JAX package's signature: the program runs on
    whichever device ``load_compiled`` moves it to, 'cpu' or 'cuda'; the
    JAX package's 'tpu' has no counterpart and raises ``ValueError``."""
    unknown = set(platforms) - {"cpu", "cuda"}
    if unknown:
        raise ValueError(
            f"platforms {sorted(unknown)}: a torch.export artifact runs on "
            "'cpu' or 'cuda' (a TPU needs the JAX package's "
            "export_compiled)")
    for i, e in enumerate(model.encoders):
        if getattr(e, "n_features", None) is None:
            raise ValueError(
                f"encoder {i} ({type(e).__name__}) does not expose "
                "n_features; export_compiled needs static input widths.")
    order = model._resolve_order(None, encoder_sequence)
    # Modality d takes the width of the encoder the pairing gives it, not
    # the width of encoder d (JAX serving.py:306-322).
    widths = {d: model.encoders[e].n_features for d, e in order}
    init_state = StaticInitState(model.init_state.bank()) \
        if isinstance(model.init_state, StaticInitState) \
        else model.init_state
    forward = make_forward_fn(model.encoders, model.decoders, init_state,
                              order, model.nan_skip,
                              model._forward_chain(order))
    module = _CompiledForward(forward,
                              params_from_jax(model.state_dict(), "cpu"))
    example = tuple(torch.zeros(_EXAMPLE_BATCH, widths[d])
                    for d in range(max(widths) + 1))
    batch = torch.export.Dim("b", min=1)
    program = torch.export.export(
        module, example, dynamic_shapes=(tuple({0: batch} for _ in example),))
    torch.export.save(_drop_noop_casts(program), path)
    return path


def load_compiled(path: str, device=None):
    """Load an ``export_compiled`` artifact onto ``device`` (CUDA unless the
    caller names another). Returns a callable that takes the per-modality
    arrays (numpy or tensors, each ``(b, F)``, any ``b >= 1``) and returns
    the per-decoder ``(E+1, b, C_d)`` output tensors on that device. It
    builds no model: the file alone is the program (``torch.export.load``
    reads it in any process with a compatible torch)."""
    device = resolve_device(device)
    program = torch.export.load(path)
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, device)
    module = program.module()

    @torch.no_grad()
    def run(*modalities):
        return module(*(torch.as_tensor(np.asarray(m, np.float32)
                                        if not torch.is_tensor(m) else m,
                                        dtype=torch.float32, device=device)
                        for m in modalities))

    return run
