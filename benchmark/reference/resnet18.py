"""MultiModN's ``ResNetEncoder``: torchvision's ``resnet18`` (He et al. 2016)
without its ``fc``, then ``Linear(512 + S, S)`` over ``[features, state]``.

Written out from the published topology: a 7x7/2 convolution, BatchNorm,
ReLU, a 3x3/2 max pool, four stages of two basic blocks (widths 64, 128,
256, 512; stride 2 and a 1x1 downsample with its BatchNorm on the first
block of stages 2-4), global average pooling. Images arrive (B, H, W, 3);
kernels are stored (kh, kw, cin, cout), the layout the benchmark hands to
both sides, and turned into torch's (cout, cin, kh, kw) here.

In training, BatchNorm normalises with the statistics of the batch (mean
and biased variance over rows x H x W). The rows are the images that are
present: this reference runs the network on those rows alone, so an absent
image, whose state the chain keeps, can never reach the statistics. In
evaluation it uses the stored ``mean`` and ``var``. Training never changes
the stored statistics (the model's are a separate running update).
"""
import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def _conv_leaves(path, k, cin, cout):
    std = (2.0 / (k * k * cout)) ** 0.5      # kaiming normal, fan-out
    return [(path + ("w",), (k, k, cin, cout), ("normal", std)),
            (path + ("bn", "scale"), (cout,), ("const", 1.0)),
            (path + ("bn", "bias"), (cout,), ("const", 0.0)),
            (path + ("bn", "mean"), (cout,), ("const", 0.0)),
            (path + ("bn", "var"), (cout,), ("const", 1.0))]


def blocks(entry: dict):
    """``(stage, block, cin, cout, stride)`` of every basic block."""
    cin = entry["stem_width"]
    out = []
    for s, (cout, n) in enumerate(zip(entry["widths"], entry["blocks"])):
        for b in range(n):
            stride = 2 if (s > 0 and b == 0) else 1
            out.append((s, b, cin, cout, stride))
            cin = cout
    return out


def leaves(entry: dict, state_size: int) -> list:
    out = _conv_leaves(("stem",), entry["stem_kernel"], entry["image"][2],
                       entry["stem_width"])
    for s, b, cin, cout, stride in blocks(entry):
        p = ("stages", s, b)
        out += _conv_leaves(p + ("conv1",), 3, cin, cout)
        out += _conv_leaves(p + ("conv2",), 3, cout, cout)
        if stride != 1 or cin != cout:
            out += _conv_leaves(p + ("down",), 1, cin, cout)
    n_in = entry["widths"][-1] + state_size
    bound = n_in ** -0.5
    out += [(("head", "w"), (n_in, state_size), ("uniform", bound)),
            (("head", "b"), (state_size,), ("uniform", bound))]
    return out


def trunk_macs(entry: dict) -> int:
    """Multiply-adds of the convolutions on one image (the products that
    the published 1.81 GMAC of ``resnet18`` without its ``fc`` counts)."""
    def out(n, k, s):
        return (n + 2 * ((k - 1) // 2) - k) // s + 1

    h, w, c = entry["image"]
    k = entry["stem_kernel"]
    h, w = out(h, k, 2), out(w, k, 2)
    total = h * w * k * k * c * entry["stem_width"]
    h, w = out(h, 3, 2), out(w, 3, 2)           # the max pool
    for _s, _b, cin, cout, stride in blocks(entry):
        h2, w2 = out(h, 3, stride), out(w, 3, stride)
        total += h2 * w2 * 9 * (cin * cout + cout * cout)
        if stride != 1 or cin != cout:
            total += h2 * w2 * cin * cout
        h, w = h2, w2
    return total


def macs(entry: dict, state_size: int) -> int:
    """Multiply-adds of one present image: the trunk and the head."""
    return trunk_macs(entry) + (entry["widths"][-1] + state_size) * \
        state_size


def _conv(x, w, stride):
    k = w.shape[0]
    return F.conv2d(x, w.permute(3, 2, 0, 1).contiguous(), stride=stride,
                    padding=(k - 1) // 2)


def _bn(x, bn, train):
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
    else:
        mean, var = bn["mean"], bn["var"]
    scale = bn["scale"] / torch.sqrt(var + BN_EPS)
    return (x - mean[None, :, None, None]) * scale[None, :, None, None] \
        + bn["bias"][None, :, None, None]


def features(params: dict, entry: dict, images, train: bool):
    """(n, H, W, C) -> (n, 512) pooled features."""
    x = images.permute(0, 3, 1, 2).contiguous()
    stem = params["stem"]
    x = torch.relu(_bn(_conv(x, stem["w"], 2), stem["bn"], train))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for s, b, cin, cout, stride in blocks(entry):
        p = params["stages"][s][b]
        h = torch.relu(_bn(_conv(x, p["conv1"]["w"], stride),
                           p["conv1"]["bn"], train))
        h = _bn(_conv(h, p["conv2"]["w"], 1), p["conv2"]["bn"], train)
        if "down" in p:
            x = _bn(_conv(x, p["down"]["w"], stride), p["down"]["bn"], train)
        x = torch.relu(h + x)
    return x.mean(dim=(2, 3))


def apply(params: dict, entry: dict, state, images, valid, train: bool):
    """(B, S) new state of every row; rows where ``valid`` is False get the
    head over zero features and are discarded by the chain's skip."""
    feats = state.new_zeros((state.shape[0], entry["widths"][-1]))
    idx = torch.nonzero(valid).reshape(-1)
    if idx.numel():
        feats = feats.index_copy(0, idx, features(
            params, entry, images.index_select(0, idx), train))
    head = params["head"]
    return torch.cat([feats, state], dim=1) @ head["w"] + head["b"]
