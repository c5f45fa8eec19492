"""ResNet-18 image encoder (PyTorch twin of
``multimodn_tpu/encoders/resnet.py``).

The reference wraps a torchvision ``resnet18`` with its final fc replaced by
the identity and a new head ``Linear(512 + state_size, state_size)`` over
``[resnet(img), state]``. Here the topology is written out: a 7x7/2 stem,
``MaxPool2d(3, 2, padding=1)``, 4 stages of 2 basic blocks (widths 64, 128,
256, 512; a 1x1 downsample on the first block of stages 2-4) and a global
average pool.

The parameters keep the JAX package's layout: HWIO convolution kernels and
the BatchNorm ``scale`` / ``bias`` / ``mean`` / ``var`` in the tree, under
``stem``, ``stages[s][b]`` (``conv1``, ``conv2``, ``down``) and ``head``;
images are NHWC. ``apply`` reads NHWC storage as an NCHW view (channels-last
memory) and HWIO kernels as OIHW views, so ``export_model`` files and
optimizer states cross between the packages as copies, and the fused Adam
kernel sees each kernel as the JAX package's ``(kh*kw*cin, cout)`` rows.
Padding is torch's symmetric ``(k-1)//2`` per side. The convolutions are
``F.conv2d`` (cuDNN on the card, which runs fp32 convolutions in TF32 while
``torch.backends.cudnn.allow_tf32`` is True, PyTorch's default).

BatchNorm normalizes with batch statistics in training (the biased variance
over the real rows x H x W: a ``sample_mask`` drops padded rows and, from the
chain, rows whose image holds a NaN) and with the stored statistics in
evaluation. Training never changes the stored statistics, as in the JAX
package: ``update_batch_stats`` is the explicit running-average update.

On a mesh's data axis (a ``"data_axis"`` tag in the parameters,
``parallel.dp_step.DataParallel.view``) each rank holds a block of the
batch's rows and the moments are the GLOBAL batch's, as the JAX package's
sums over a sharded batch are: one summing ``all_reduce`` of ``[sum of w,
sum of w * x per channel]``, then one of ``sum of w * (x - mean)^2`` per
channel (the two-pass variance, in the JAX package's order), two per
BatchNorm (``parallel.collectives.AxisSum``, which also sums their
gradients across the axis).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from multimodn_tpu_torch.core.nn import dense_apply, dense_init
from multimodn_tpu_torch.core.tree import tree_map
from multimodn_tpu_torch.encoders.base import MultiModEncoder
from multimodn_tpu_torch.parallel.collectives import AxisSum

STAGES = (64, 128, 256, 512)
BLOCKS_PER_STAGE = 2
BN_EPS = 1e-5


def _conv_init(generator, kh, kw, cin, cout, device=None):
    """He-normal with fan-out, torchvision's ResNet init, stored HWIO."""
    std = float(np.sqrt(2.0 / (kh * kw * cout)))
    return (torch.randn((kh, kw, cin, cout), generator=generator)
            * std).to(device)


def _bn_init(c, device=None):
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device),
            "mean": torch.zeros((c,), device=device),
            "var": torch.ones((c,), device=device)}


def _conv(x, w, stride):
    """``x`` (B, C, H, W) with an HWIO kernel ``w``, torch-exact padding."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride,
                    padding=((kh - 1) // 2, (kw - 1) // 2))


def _channels(v):
    return v.reshape(1, -1, 1, 1)


def batch_stats(x, mask=None, axis=None):
    """Per-channel mean and biased variance of ``x`` (B, C, H, W) over the
    rows where ``mask`` (B,) is 1, all of them without one, in ``x``'s
    dtype; the count is ``max(rows x H x W, 1)``. ``axis``: a mesh's data
    axis whose ranks hold the other rows of the batch (the chain passes a
    mask with it); the sums are taken over every rank's rows (module
    docstring)."""
    if mask is None:
        mean = x.mean(dim=(0, 2, 3))
        return mean, ((x - _channels(mean)) ** 2).mean(dim=(0, 2, 3))
    w = mask.reshape(-1, 1, 1, 1).to(x.dtype)
    n, sx = w.sum().reshape(1), (x * w).sum(dim=(0, 2, 3))
    if axis is not None:
        n, sx = AxisSum.apply(torch.cat([n, sx]), axis).split(
            [1, sx.shape[0]])
    denom = (n[0] * (x.shape[2] * x.shape[3])).clamp_min(1.0)
    mean = sx / denom
    sq = (w * (x - _channels(mean)) ** 2).sum(dim=(0, 2, 3))
    if axis is not None:
        sq = AxisSum.apply(sq, axis)
    return mean, sq / denom


def _bn(x, p, train, mask=None, axis=None):
    mean, var = batch_stats(x, mask, axis) if train else (p["mean"],
                                                          p["var"])
    inv = torch.rsqrt(var + BN_EPS)
    return (x - _channels(mean)) * _channels(inv) * _channels(p["scale"]) \
        + _channels(p["bias"])


def _trunk(params, images, train, mask=None, record=None, axis=None):
    """(B, H, W, 3) -> (B, 512) pooled features. ``record(path, h)`` sees
    each BatchNorm's input, ``path`` naming its ``bn`` dict in the tree;
    ``axis``: the data axis of the batch statistics (``batch_stats``)."""
    def bn(h, path, p):
        if record is not None:
            record(path, h)
        return _bn(h, p["bn"], train, mask, axis)

    x = _conv(images.permute(0, 3, 1, 2), params["stem"]["w"], 2)
    x = torch.relu(bn(x, ("stem",), params["stem"]))
    x = F.max_pool2d(x, 3, 2, padding=1)      # -inf padding, as torch's
    for s, blocks in enumerate(params["stages"]):
        for b, block in enumerate(blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            h = torch.relu(bn(_conv(x, block["conv1"]["w"], stride),
                              ("stages", s, b, "conv1"), block["conv1"]))
            h = bn(_conv(h, block["conv2"]["w"], 1),
                   ("stages", s, b, "conv2"), block["conv2"])
            shortcut = x
            if "down" in block:
                shortcut = bn(_conv(x, block["down"]["w"], stride),
                              ("stages", s, b, "down"), block["down"])
            x = torch.relu(h + shortcut)
    return x.mean(dim=(2, 3))


class ResNet(MultiModEncoder):
    """ResNet-18 image encoder with a state-concat head.

    ``apply(params, state (B, S), images (B, H, W, 3)) -> (B, S)``.
    ``freeze`` stops the gradient at the pooled features, so only the head
    trains. ``pretrained_path`` overlays a local ``.npz`` of the flattened
    parameter tree (keys such as ``'stem/w'`` or
    ``'stages/0/0/conv1/bn/scale'``) on the initial parameters; there are
    no downloaded weights (``pretrained=True`` raises)."""

    # The chain passes the effective per-sample mask (real rows whose image
    # holds no NaN) so that train-mode BatchNorm statistics see only those.
    _accepts_sample_mask = True

    def __init__(self, *, state_size: int, freeze: bool = False,
                 pretrained_path: Optional[str] = None,
                 pretrained: bool = False):
        super().__init__(state_size, n_features=None)
        if pretrained_path is not None and pretrained:
            raise ValueError(
                "Loading a pretrained ResNet should either be from a local "
                "checkpoint (pretrained_path) or default init, not both.")
        if pretrained:
            raise ValueError(
                "No network access: supply pretrained weights as a local "
                ".npz via pretrained_path (numpy tree of this module).")
        if state_size < 1:
            raise ValueError(f"ResNet needs state_size >= 1, got {state_size}")
        self.freeze = freeze
        self.pretrained_path = pretrained_path

    def init(self, generator, device=None) -> dict:
        params = {
            "stem": {"w": _conv_init(generator, 7, 7, 3, 64, device),
                     "bn": _bn_init(64, device)},
            "stages": [],
            "head": dense_init(generator, 512 + self.state_size,
                               self.state_size, device),
        }
        cin = 64
        for s, cout in enumerate(STAGES):
            blocks = []
            for b in range(BLOCKS_PER_STAGE):
                stride = 2 if (s > 0 and b == 0) else 1
                block = {
                    "conv1": {"w": _conv_init(generator, 3, 3, cin, cout,
                                              device),
                              "bn": _bn_init(cout, device)},
                    "conv2": {"w": _conv_init(generator, 3, 3, cout, cout,
                                              device),
                              "bn": _bn_init(cout, device)},
                }
                if stride != 1 or cin != cout:
                    block["down"] = {
                        "w": _conv_init(generator, 1, 1, cin, cout, device),
                        "bn": _bn_init(cout, device)}
                blocks.append(block)
                cin = cout
            params["stages"].append(blocks)
        if self.pretrained_path:
            params = self._load_npz(params, self.pretrained_path)
        return params

    @staticmethod
    def _load_npz(params, path):
        """Overlay a flat .npz onto the initial tree; a key it lacks keeps
        its initial value."""
        with np.load(path) as npz:
            flat = dict(npz)

        def walk(tree, prefix):
            if isinstance(tree, dict):
                return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                        for k, v in tree.items()}
            if isinstance(tree, list):
                return [walk(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
            if prefix not in flat:
                return tree
            return torch.as_tensor(np.asarray(flat[prefix], np.float32),
                                   device=tree.device)

        return walk(params, "")

    def features(self, params, images, train=False, mask=None):
        """(B, H, W, 3) -> (B, 512) globally average-pooled features; under
        a ``"data_axis"`` tag the training statistics are the global
        batch's."""
        return _trunk(params, images, train, mask,
                      axis=params.get("data_axis"))

    def apply(self, params, state, x, train=False, generator=None,
              sample_mask=None):
        feats = self.features(params, x, train=train, mask=sample_mask)
        if self.freeze:
            feats = feats.detach()
        return dense_apply(params["head"], torch.cat([feats, state], dim=-1))

    @torch.no_grad()
    def update_batch_stats(self, params, images, momentum: float = 0.9,
                           sample_mask=None):
        """A copy of ``params`` whose BatchNorm statistics take one batch's
        into their running average: ``momentum * stored + (1 - momentum) *
        batch`` (torch's ``momentum=0.1`` is 0.9 here). The batch statistics
        are those train-mode BatchNorm uses, layer after layer; a
        ``sample_mask`` (B,) leaves padded rows out of them."""
        like = params["stem"]["w"]
        images = torch.as_tensor(images, dtype=like.dtype, device=like.device)
        if sample_mask is not None:
            sample_mask = torch.as_tensor(sample_mask, dtype=torch.float32,
                                          device=like.device)
        new = tree_map(torch.clone, params)

        def record(path, h):
            node = new
            for key in path:
                node = node[key]
            mean, var = batch_stats(h, sample_mask)
            bn = node["bn"]
            bn["mean"] = momentum * bn["mean"] + (1 - momentum) * mean
            bn["var"] = momentum * bn["var"] + (1 - momentum) * var

        _trunk(params, images, True, sample_mask, record)
        return new
