"""MultiModN's chain (Swamy et al. 2023, ``multimodn.py``), plainly.

A state of ``S`` numbers starts at a trained initial row, then each encoder
in turn reads its modality and the state and writes a new state. A sample
whose modality holds a NaN skips that encoder and keeps its state
(``nan_skip='sample'``). Every decoder reads every state: the initial one
and the one after each encoder, E+1 rows. The training loss is the mean
over those rows and the decoders of the cross-entropy of each decoder's
outputs (as scores) against its target, times ``err_penalty``, plus the
mean squared state change times ``state_change_penalty`` (which the
published constructor scales by 0.01). The optimizer is
``torch.optim.Adam``, as published.
"""
import statistics

import torch

from benchmark import reference


def leaves(cfg: dict) -> list:
    """``(path, shape, init)`` of every parameter, in the tree that both
    sides get: ``init_state/value``, ``encoders/<e>/...``,
    ``decoders/<d>/...``."""
    S = cfg["state_size"]
    out = [(("init_state", "value"), (1, S), ("normal", 1.0))]
    for e, entry in enumerate(cfg["encoders"]):
        out += [(("encoders", e) + p, shape, init) for p, shape, init in
                reference.kind(entry["kind"]).leaves(entry, S)]
    for d, entry in enumerate(cfg["decoders"]):
        out += [(("decoders", d) + p, shape, init) for p, shape, init in
                reference.kind(entry["kind"]).leaves(entry, S)]
    return out


def present(x):
    """(B,) True where a sample's modality holds no NaN."""
    return ~torch.isnan(x.reshape(x.shape[0], -1)).any(dim=1)


def states(params: dict, cfg: dict, data, train: bool = False):
    """(E+1, B, S): the initial state and the state after each encoder."""
    B = data[0].shape[0]
    state = params["init_state"]["value"].expand(B, cfg["state_size"])
    rows = [state]
    for e, entry in enumerate(cfg["encoders"]):
        x = data[e]
        ok = present(x)
        new = reference.kind(entry["kind"]).apply(
            params["encoders"][e], entry, state, torch.nan_to_num(x), ok,
            train)
        state = torch.where(ok[:, None], new, state)
        rows.append(state)
    return torch.stack(rows)


def outputs(params: dict, cfg: dict, rows):
    """Per decoder, (E+1, B, C_d): each decoder on each state row."""
    return [reference.kind(entry["kind"]).apply(params["decoders"][d],
                                                entry, rows)
            for d, entry in enumerate(cfg["decoders"])]


def loss(params: dict, cfg: dict, data, targets):
    """The training loss of one batch whose rows are all real."""
    rows = states(params, cfg, data, train=True)
    outs = outputs(params, cfg, rows)
    ce = [(torch.logsumexp(o, dim=-1)
           - o.gather(-1, targets[None, :, d, None].expand(
               o.shape[0], -1, 1).long()).squeeze(-1)).mean(dim=1)
          for d, o in enumerate(outs)]
    err = torch.stack(ce).mean()
    change = ((rows[1:] - rows[:-1]) ** 2).mean(dim=(1, 2)).mean()
    return cfg["err_penalty"] * err + \
        0.01 * cfg["state_change_penalty"] * change


def train_steps(params: dict, cfg: dict, batches, lr: float, betas, eps):
    """``torch.optim.Adam`` over ``batches`` (``(data, targets)`` each) from
    ``params`` (whose leaves it updates in place). Returns each step's loss,
    the first step's gradient by leaf, and the final parameters by leaf, in
    ``leaves(cfg)`` order."""
    paths = [p for p, _shape, _init in leaves(cfg)]
    flat = [_get(params, p) for p in paths]
    for t in flat:
        t.requires_grad_(True)
    opt = torch.optim.Adam(flat, lr=lr, betas=tuple(betas), eps=eps)
    losses, first_grads = [], None
    for data, targets in batches:
        opt.zero_grad(set_to_none=True)
        value = loss(params, cfg, data, targets)
        value.backward()
        losses.append(float(value.detach()))
        if first_grads is None:
            first_grads = [torch.zeros_like(t) if t.grad is None
                           else t.grad.detach().clone() for t in flat]
        opt.step()
    return losses, first_grads, [t.detach() for t in flat]


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def leaf_norm_gaps(program, reference_norms, counted) -> list:
    """The gap between the program's and the reference's norm of each leaf
    that ``counted`` marks, against the reference's norm of that leaf or
    of the median counted leaf, whichever is larger."""
    kept = [r for r, c in zip(reference_norms, counted) if c]
    median = statistics.median(kept)
    return [abs(p - r) / max(r, median)
            for p, r, c in zip(program, reference_norms, counted) if c]
