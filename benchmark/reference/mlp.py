"""MultiModN's ``MLPDecoder``: hidden ``Linear`` layers with the hidden
activation, then a ``Linear`` to the classes and the output activation (a
sigmoid in the published model, which the cross-entropy then reads as
scores)."""
import torch

ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh,
               "sigmoid": torch.sigmoid,
               "softmax": lambda x: torch.softmax(x, dim=-1)}


def dims(entry: dict, state_size: int) -> list:
    return [state_size] + list(entry["hidden"]) + [entry["n_classes"]]


def leaves(entry: dict, state_size: int) -> list:
    out = []
    d = dims(entry, state_size)
    for i, (n_in, n_out) in enumerate(zip(d[:-1], d[1:])):
        bound = n_in ** -0.5
        out.append((("layers", i, "w"), (n_in, n_out), ("uniform", bound)))
        out.append((("layers", i, "b"), (n_out,), ("uniform", bound)))
    return out


def macs(entry: dict, state_size: int) -> int:
    """Multiply-adds of one state row."""
    d = dims(entry, state_size)
    return sum(a * b for a, b in zip(d[:-1], d[1:]))


def apply(params: dict, entry: dict, state):
    hidden = ACTIVATIONS[entry.get("activation", "relu")]
    out_act = ACTIVATIONS[entry.get("output_activation", "sigmoid")]
    h = state
    layers = params["layers"]
    for layer in layers[:-1]:
        h = hidden(h @ layer["w"] + layer["b"])
    return out_act(h @ layers[-1]["w"] + layers[-1]["b"])
