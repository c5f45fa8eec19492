"""The MIMIC MLP encoder (MultiModN's ``MIMIC_MLPEncoder``): the state joins
the modality at the first layer's input, inverted dropout acts on that
concatenation in training, and every layer, the last included, is a
``Linear`` followed by the activation."""
import torch

ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh,
               "sigmoid": torch.sigmoid}


def dims(entry: dict, state_size: int) -> list:
    return [entry["width"] + state_size] + list(entry["hidden"]) + \
        [state_size]


def leaves(entry: dict, state_size: int) -> list:
    """``(path, shape, init)``: ``torch.nn.Linear``'s U(-1/sqrt(fan_in),
    +1/sqrt(fan_in)) for weight (stored (in, out)) and bias."""
    out = []
    d = dims(entry, state_size)
    for i, (n_in, n_out) in enumerate(zip(d[:-1], d[1:])):
        bound = n_in ** -0.5
        out.append((("layers", i, "w"), (n_in, n_out), ("uniform", bound)))
        out.append((("layers", i, "b"), (n_out,), ("uniform", bound)))
    return out


def macs(entry: dict, state_size: int) -> int:
    """Multiply-adds of one present row."""
    d = dims(entry, state_size)
    return sum(a * b for a, b in zip(d[:-1], d[1:]))


def apply(params: dict, entry: dict, state, x, valid, train: bool):
    """(B, S) new state; ``valid`` is unused: rows are independent."""
    if train and entry.get("dropout", 0.0) > 0.0:
        raise ValueError("the reference cannot redraw the program's dropout "
                         "masks; train with dropout 0")
    act = ACTIVATIONS[entry.get("activation", "relu")]
    h = torch.cat([x.reshape(x.shape[0], -1), state], dim=1)
    for layer in params["layers"]:
        h = act(h @ layer["w"] + layer["b"])
    return h
