"""Weights and inputs made on the device from the seed, in a few large
calls: one normal draw for every normally initialised leaf, one uniform draw
for every uniformly initialised one."""
import torch


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one ``stream`` of a seed's draws
    (weights, data, order), so that each is the same whatever the others
    draw."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def make_tree(specs, seed: int, device) -> dict:
    """The nested dict/list tree of ``specs`` (``(path, shape, init)``, init
    ``("normal", std)``, ``("uniform", bound)`` or ``("const", value)``) as
    float32 tensors on ``device``."""
    sizes = {"normal": 0, "uniform": 0}
    for _path, shape, (kind, _v) in specs:
        if kind in sizes:
            sizes[kind] += _numel(shape)
    gen = generator(seed, device, 0)
    pools = {
        "normal": torch.randn(sizes["normal"], generator=gen, device=device),
        "uniform": torch.rand(sizes["uniform"], generator=gen,
                              device=device) * 2.0 - 1.0,
    }
    used = {"normal": 0, "uniform": 0}
    tree: dict = {}
    for path, shape, (kind, value) in specs:
        n = _numel(shape)
        if kind == "const":
            leaf = torch.full(shape, float(value), device=device)
        else:
            start = used[kind]
            used[kind] += n
            leaf = (pools[kind][start:start + n] * value).reshape(shape)
        _put(tree, path, leaf)
    return tree


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _put(tree, path, leaf):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        child = [] if isinstance(nxt, int) else {}
        if isinstance(key, int):
            while len(node) <= key:
                node.append(None)
            if node[key] is None:
                node[key] = child
        else:
            node.setdefault(key, child)
        node = node[key]
    if isinstance(path[-1], int):
        while len(node) <= path[-1]:
            node.append(None)
        node[path[-1]] = leaf
    else:
        node[path[-1]] = leaf


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.detach().clone()


def same_layout(a, b, path=()) -> None:
    """Raise where two trees differ in keys, lengths or leaf shapes."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) or \
                set(a) != set(b):
            raise ValueError(f"parameter trees differ at {path}")
        for k in a:
            same_layout(a[k], b[k], path + (k,))
    elif isinstance(a, list) or isinstance(b, list):
        if not (isinstance(a, list) and isinstance(b, list)) or \
                len(a) != len(b):
            raise ValueError(f"parameter trees differ at {path}")
        for i, (x, y) in enumerate(zip(a, b)):
            same_layout(x, y, path + (i,))
    elif tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"leaf {path}: shape {tuple(a.shape)} against "
                         f"{tuple(b.shape)}")


def modalities(cfg: dict, rows: int, missing: float, seed: int, stream: int,
               device) -> list:
    """One float32 tensor per encoder: Gaussian values of the modality's
    shape, with exactly ``round(missing * rows)`` rows of each modality
    all NaN (the rows drawn from the seed), so every seed does the same
    amount of work."""
    gen = generator(seed, device, stream)
    out = []
    n_missing = int(round(missing * rows))
    for entry in cfg["encoders"]:
        shape = (rows,) + tuple(entry.get("image") or (entry["width"],))
        x = torch.randn(shape, generator=gen, device=device)
        gone = torch.randperm(rows, generator=gen, device=device)[:n_missing]
        x[gone] = float("nan")
        out.append(x)
    return out


def targets(cfg: dict, rows: int, seed: int, stream: int, device):
    """(rows, D) int64 class labels drawn uniformly from the seed."""
    gen = generator(seed, device, stream)
    cols = [torch.randint(entry["n_classes"], (rows,), generator=gen,
                          device=device) for entry in cfg["decoders"]]
    return torch.stack(cols, dim=1)
