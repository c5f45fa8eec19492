"""HAIM: the parallel-fusion baseline (PyTorch twin of
``multimodn_tpu/baselines/haim.py``).

A monolithic MLP over the concatenated features of every modality, trained
with one cross-entropy loss: the "P-fusion" model the MultiModN paper
compares against (reference ``pipelines/mimic/haim_api.py``). Parameters are
a ``{"layers": [{"w", "b"}, ...]}`` tree of float32 tensors on the model's
device, in the JAX package's ``(in, out)`` layout, so ``state_dict`` /
``load_state_dict`` exchange weights with the JAX package as plain copies.

Training is a Python loop over the loader's device-resident batches (as
``MultiModN``'s); ``fit_best`` reads one score per epoch on the host.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

import numpy as np
import torch

from multimodn_tpu_torch.convert import haim_params_from_jax, params_to_numpy
from multimodn_tpu_torch.core.losses import resolve_criterion
from multimodn_tpu_torch.core.metrics import (
    get_performance_metrics,
    masked_binary_auroc,
    safe_div,
)
from multimodn_tpu_torch.core.nn import (
    dense_apply,
    mlp_init,
    resolve_activation,
    resolve_device,
)
from multimodn_tpu_torch.core.step import gated_update
from multimodn_tpu_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from multimodn_tpu_torch.optim import Optimizer


class HAIMDecoder:
    """Plain MLP ``n_features -> hidden -> n_classes`` with a sigmoid
    output (reference ``haim_api.py:14-36``)."""

    def __init__(self, n_features: int, hidden_layers: Sequence[int],
                 n_classes: int = 2,
                 hidden_activation: Union[str, Callable] = "relu",
                 output_activation: Union[str, Callable] = "sigmoid"):
        self.n_features = n_features
        self.n_classes = n_classes
        self.hidden_activation = resolve_activation(hidden_activation)
        self.output_activation = resolve_activation(output_activation)
        self._dims = [n_features] + list(hidden_layers) + [n_classes]

    def init(self, generator: torch.Generator, device=None) -> dict:
        return {"layers": mlp_init(generator, self._dims, device)}

    def apply(self, params, x):
        for layer in params["layers"][:-1]:
            x = self.hidden_activation(dense_apply(layer, x))
        return self.output_activation(dense_apply(params["layers"][-1], x))


def _single_modality(loader, device):
    """The loader's epoch stacks with every modality concatenated:
    ``(x (n_batches, B, F), targets, mask)`` on ``device``."""
    data, targets, mask = loader.stacks(device)
    x = data[0] if len(data) == 1 else torch.cat(data, dim=-1)
    return x, targets, mask


class HAIM:
    """The baseline model. ``device`` defaults to CUDA; without a GPU the
    caller must pass ``device="cpu"``."""

    def __init__(self, decoder: HAIMDecoder, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.decoder = decoder
        self.params = decoder.init(torch.Generator().manual_seed(seed),
                                   self.device)
        self._opt = None
        self.opt_state = None
        self._seed = seed
        self._epoch_counter = 0

    def _use_optimizer(self, optimizer: Optimizer):
        """A new optimizer starts a new state; the same one continues."""
        if self._opt is not optimizer or self.opt_state is None:
            self._opt = optimizer
            self.opt_state = optimizer.init(self.params)

    def _train_pass(self, loader, optimizer, criterion):
        """One epoch of steps over the loader's batches (each padded batch
        masked by the criterion)."""
        loader.reshuffle()
        x, targets, mask = _single_modality(loader, self.device)
        for b in range(x.shape[0]):
            live = tree_map(lambda p: p.detach().requires_grad_(),
                            self.params)
            leaves = tree_leaves(live)
            loss = criterion(self.decoder.apply(live, x[b]),
                             targets[b][:, 0], mask[b])
            grads = tree_unflatten(self.params,
                                   torch.autograd.grad(loss, leaves))
            with torch.no_grad():
                self.opt_state = gated_update(optimizer, grads,
                                              self.opt_state, self.params)

    @torch.no_grad()
    def _score(self, loader) -> torch.Tensor:
        """Validation AUROC plus balanced accuracy on outputs normalised by
        their row sums, guarded by ``max(sum, 1e-12)`` (the reference's
        ``mimic_single_task_pipeline.py:210-228`` rule)."""
        x, targets, mask = _single_modality(loader, self.device)
        out = self.decoder.apply(self.params, x)
        out = out.reshape(-1, out.shape[-1])
        norm = out / torch.clamp_min(out.sum(dim=1, keepdim=True), 1e-12)
        t = targets.reshape(-1, targets.shape[-1])[:, 0]
        m = mask.reshape(-1).float()
        auc = masked_binary_auroc(norm[:, 1], t, m)
        pred = norm.argmax(dim=1)
        tp = (m * ((pred == 1) & (t == 1))).sum()
        tn = (m * ((pred == 0) & (t == 0))).sum()
        fp = (m * ((pred == 1) & (t == 0))).sum()
        fn = (m * ((pred == 0) & (t == 1))).sum()
        return auc + (safe_div(tp, tp + fn) + safe_div(tn, tn + fp)) / 2

    def fit_best(self, train_loader, optimizer: Optimizer, criterion=None,
                 epochs: int = 1, val_loader=None,
                 restore_best: bool = True,
                 skip_last_val: bool = False) -> dict:
        """Train ``epochs`` epochs and keep the parameters of the epoch with
        the best validation AUROC + balanced accuracy (strictly greater
        wins, from -inf).

        ``skip_last_val`` reproduces the reference MNAR script's HAIM loop,
        which never scores the last epoch on val
        (``mnar_missingness_pipeline.py:300-303``): the last epoch trains
        but cannot win, and with ``epochs == 1`` the initial parameters are
        restored with ``best_epoch == -1``. Returns ``{"best_epoch",
        "best_score", "best_params", "scores"}``."""
        if val_loader is None:
            raise ValueError("fit_best requires a val_loader")
        criterion = resolve_criterion(criterion)
        self._use_optimizer(optimizer)
        select_limit = epochs - 1 if skip_last_val else epochs
        self._epoch_counter += epochs
        best = (tree_map(torch.clone, self.params), float("-inf"), -1)
        scores = []
        for e in range(epochs):
            self._train_pass(train_loader, optimizer, criterion)
            scores.append(float(self._score(val_loader)))
            if scores[-1] > best[1] and e < select_limit:
                best = (tree_map(torch.clone, self.params), scores[-1], e)
        best_params, best_score, best_epoch = best
        if restore_best:
            self.params = best_params
        return {
            "best_epoch": best_epoch,
            "best_score": best_score,
            "best_params": params_to_numpy(best_params),
            "scores": np.asarray(scores, np.float32),
        }

    def train_epoch(self, train_loader, optimizer: Optimizer,
                    criterion=None, last_epoch: bool = False):
        return self.fit(train_loader, optimizer, criterion, epochs=1,
                        last_epoch=last_epoch)

    def fit(self, train_loader, optimizer: Optimizer, criterion=None,
            epochs: int = 1, last_epoch: bool = False):
        """Train ``epochs`` epochs; with ``last_epoch`` return ``test`` on
        the training loader."""
        criterion = resolve_criterion(criterion)
        self._use_optimizer(optimizer)
        self._epoch_counter += epochs
        for _ in range(epochs):
            self._train_pass(train_loader, optimizer, criterion)
        if last_epoch:
            return self.test(train_loader, criterion)
        return None

    @torch.no_grad()
    def _epoch_outputs(self, loader) -> Tuple[np.ndarray, np.ndarray]:
        x, targets, mask = _single_modality(loader, self.device)
        out = self.decoder.apply(self.params, x)
        out = out.reshape(-1, out.shape[-1]).cpu().numpy()
        _x, t, m = loader.host_stacks()
        keep = m.reshape(-1) > 0
        return out[keep], t.reshape(-1, t.shape[-1])[keep, 0]

    def test(self, test_loader, criterion=None) -> Tuple:
        """The 15-tuple performance suite on outputs normalised by their row
        sums, without a guard (reference ``haim_api.py:107``)."""
        out, t = self._epoch_outputs(test_loader)
        with np.errstate(invalid="ignore", divide="ignore"):
            out = out / out.sum(axis=1, keepdims=True)
        pred = out.argmax(axis=1)
        return get_performance_metrics(t, pred, out[:, 1])

    def predict(self, test_loader):
        """``(outputs (N, C), targets (N,))`` of the loader's real rows."""
        return self._epoch_outputs(test_loader)

    def state_dict(self) -> dict:
        return params_to_numpy(self.params)

    def load_state_dict(self, state: dict):
        """Load this package's or the JAX package's HAIM ``state_dict``;
        the optimizer state starts anew."""
        self.params = haim_params_from_jax(state, self.device)
        self.opt_state = None
        self._opt = None
