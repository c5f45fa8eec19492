"""Counts of the ``mimic-cxr-resnet18`` configuration, from its shapes and
the inputs' missing cells, whatever implements them: the ResNet-18 trunk
and head and the MLP encoders on present cells only, every decoder on all
E+1 states. A training step is three forward passes' work (forward, and
the two products of the backward), with no recompute."""
from benchmark.reference import kind


def forward_macs(cfg: dict, present_rows, rows: int) -> int:
    S = cfg["state_size"]
    enc = sum(n * kind(e["kind"]).macs(e, S)
              for n, e in zip(present_rows, cfg["encoders"]))
    dec = sum(kind(d["kind"]).macs(d, S) for d in cfg["decoders"])
    return enc + rows * (len(cfg["encoders"]) + 1) * dec


def train_flops(cfg: dict, present_rows, rows: int) -> int:
    """Useful FLOPs of training on ``rows`` rows."""
    return 3 * 2 * forward_macs(cfg, present_rows, rows)
