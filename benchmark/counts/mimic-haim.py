"""Counts of the ``mimic-haim`` configuration, from its shapes and the
inputs' missing cells, whatever implements them.

Encoder work and modality bytes count only the (row, modality) cells that
are present; every decoder counts on all E+1 states of every row. K1's
bound reads each input once (the present modality values, the validity
mask, the initial row, the weights) and writes each output once (the E+1
states and every decoder's outputs on them)."""
from benchmark.reference import chain, kind


def forward_macs(cfg: dict, present_rows, rows: int) -> int:
    """Multiply-adds of one forward pass over ``rows`` rows, of which
    ``present_rows[e]`` hold modality e."""
    S = cfg["state_size"]
    enc = sum(n * kind(e["kind"]).macs(e, S)
              for n, e in zip(present_rows, cfg["encoders"]))
    dec = sum(kind(d["kind"]).macs(d, S) for d in cfg["decoders"])
    return enc + rows * (len(cfg["encoders"]) + 1) * dec


def k1_bound(cfg: dict, present_rows, rows: int, peak: dict):
    """``(seconds, bound_by, flops, bytes)`` of one K1 call."""
    S, E = cfg["state_size"], len(cfg["encoders"])
    weights = sum(_numel(shape) for path, shape, _init in chain.leaves(cfg)
                  if path[0] != "init_state")
    n_in = sum(n * e["width"] for n, e in zip(present_rows, cfg["encoders"]))
    n_in += rows * E + S + weights
    n_out = (E + 1) * rows * (S + sum(d["n_classes"]
                                      for d in cfg["decoders"]))
    nbytes = 4 * (n_in + n_out)
    flops = 2 * forward_macs(cfg, present_rows, rows)
    t_ops, t_bytes = flops / peak["fp32_flops"], nbytes / peak["bytes_per_s"]
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
