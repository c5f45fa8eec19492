"""How the program under test builds each module kind of a configuration
file (``modules/<kind>.py``: ``program(entry, state_size)``). These files,
and the drivers, are the only ones that import the program."""
import importlib

KIND_PACKAGE = __name__


def kind(name: str):
    return importlib.import_module(f"{KIND_PACKAGE}.{name}")


def build(cfg: dict, weights: dict, device):
    """The program's ``MultiModN`` of a configuration file, holding
    ``weights`` (the benchmark's tree, whose layout it must share)."""
    import torch

    from multimodn_tpu_torch import MultiModN
    from benchmark.harness.weights import same_layout

    if cfg["init_state"] != "trainable" or cfg["dtype"] != "float32":
        raise ValueError("the benchmark builds fp32 models with a trainable "
                         "initial state")
    S = cfg["state_size"]
    model = MultiModN(
        S, [kind(e["kind"]).program(e, S) for e in cfg["encoders"]],
        [kind(d["kind"]).program(d, S) for d in cfg["decoders"]],
        cfg["err_penalty"], cfg["state_change_penalty"],
        nan_skip=cfg["nan_skip"], device=torch.device(device))
    same_layout(model.params, weights)
    model.params = weights
    return model
