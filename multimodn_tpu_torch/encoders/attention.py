"""Attention encoders (PyTorch twin of
``multimodn_tpu/encoders/attention.py``): a pre-LN transformer over
feature-chunk tokens, and a Vision Transformer whose patches are those
tokens.

The parameter tree has the JAX package's keys (``embed``, ``pos``, ``out``,
``ln_f`` and a ``blocks`` list of ``ln1`` / ``qkv`` / ``proj`` / ``ln2`` /
``mlp1`` / ``mlp2``), so weights and optimizer states cross between the
packages as copies. The operations run in the JAX package's order:
LayerNorm with the population variance, logits divided by ``sqrt(head_dim)``
after the product, softmax, dropout on the attention branch only.

On a mesh nothing here changes: under a model axis every dense layer runs
column-parallel (``qkv``'s gathered output is split into q, k and v in
this order) and the LayerNorm vectors and position table arrive whole
(``parallel.dp_step.DataParallel.view``); under a data axis the dropout
draws at the global batch's shape (``parallel.dp_step.RowStream``).
"""
from __future__ import annotations

from typing import Callable, Union

import torch

from multimodn_tpu_torch.core.nn import (
    dense_apply,
    dense_init,
    dropout,
    resolve_activation,
)
from multimodn_tpu_torch.encoders.base import MultiModEncoder


def _layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    xhat = (x - mu) * torch.rsqrt(var + eps)
    return xhat * params["scale"] + params["bias"]


def _ln_init(dim: int, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device),
            "bias": torch.zeros((dim,), dtype=torch.float32, device=device)}


class TransformerEncoder(MultiModEncoder):
    """Pre-LN transformer over feature-chunk tokens.

    (B, n_features) input -> zero-pad to a multiple of ``chunk`` -> (B, T,
    chunk) tokens -> linear embed (+ learned positions) -> ``n_layers``
    pre-LN blocks (multi-head attention and an MLP with ``activation``,
    residuals, dropout on the attention branch in training) -> final
    LayerNorm -> mean over tokens -> ``out`` dense on ``[h, state]``. A
    (B, T, F) input is taken as tokens directly.
    """

    def __init__(self, state_size: int, n_features: int, embed_dim: int = 256,
                 n_heads: int = 4, n_layers: int = 2, mlp_ratio: int = 4,
                 chunk: int = 64, dropout_rate: float = 0.0,
                 activation: Union[str, Callable] = "gelu"):
        super().__init__(state_size, n_features)
        if embed_dim % n_heads:
            raise ValueError(f"embed_dim {embed_dim} % n_heads {n_heads} != 0")
        self.embed_dim = embed_dim
        self.n_heads = n_heads
        self.n_layers = n_layers
        self.mlp_ratio = mlp_ratio
        self.mlp_dim = embed_dim * mlp_ratio
        self.chunk = chunk
        self.dropout_rate = dropout_rate
        self.activation = resolve_activation(activation)
        self.n_tokens = -(-n_features // chunk)
        self.pad = self.n_tokens * chunk - n_features

    @property
    def stochastic(self) -> bool:
        """Whether ``apply`` draws from the generator in training."""
        return self.dropout_rate > 0

    def init(self, generator, device=None) -> dict:
        D = self.embed_dim
        params = {
            "embed": dense_init(generator, self.chunk, D, device),
            "pos": torch.zeros((self.n_tokens, D), dtype=torch.float32,
                               device=device),
            "out": dense_init(generator, D + self.state_size,
                              self.state_size, device),
            "blocks": [],
            "ln_f": _ln_init(D, device),
        }
        for _ in range(self.n_layers):
            params["blocks"].append({
                "ln1": _ln_init(D, device),
                "qkv": dense_init(generator, D, 3 * D, device),
                "proj": dense_init(generator, D, D, device),
                "ln2": _ln_init(D, device),
                "mlp1": dense_init(generator, D, self.mlp_dim, device),
                "mlp2": dense_init(generator, self.mlp_dim, D, device),
            })
        return params

    def _attend(self, block: dict, h: torch.Tensor) -> torch.Tensor:
        B, T, D = h.shape
        H = self.n_heads
        hd = D // H
        q, k, v = dense_apply(block["qkv"], h).split(D, dim=-1)

        def heads(t):
            return t.reshape(B, T, H, hd).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        # Tensor by tensor: a Python scalar divisor may round twice.
        scale = torch.tensor(float(hd), device=logits.device).sqrt()
        att = torch.softmax(logits / scale, dim=-1).to(v.dtype)
        out = torch.matmul(att.float(), v.float()).to(h.dtype)
        return dense_apply(block["proj"],
                           out.transpose(1, 2).reshape(B, T, D))

    def _tokens(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 2:
            return x
        if self.pad:
            x = torch.nn.functional.pad(x, (0, self.pad))
        return x.reshape(x.shape[0], self.n_tokens, self.chunk)

    def apply(self, params, state, x, train=False, generator=None):
        h = dense_apply(params["embed"], self._tokens(x)) + \
            params["pos"][None].to(x.dtype)
        for block in params["blocks"]:
            a = self._attend(block, _layernorm(block["ln1"], h))
            h = h + dropout(a, self.dropout_rate, generator, train)
            m = dense_apply(block["mlp2"], self.activation(
                dense_apply(block["mlp1"], _layernorm(block["ln2"], h))))
            h = h + m
        h = _layernorm(params["ln_f"], h).mean(dim=1)
        return dense_apply(params["out"], torch.cat([h, state], dim=-1))


class ViTEncoder(TransformerEncoder):
    """Vision Transformer image encoder with a state-concat head.

    ``apply(params, state (B, S), images (B, H, W, C) or flat
    (B, H*W*C)) -> (B, S)``: non-overlapping ``patch_size`` patches become
    the parent's tokens (``chunk = patch² · channels``, so ``embed`` is the
    patch embedding and ``pos`` the position table); flat inputs are read
    as (H, W, C) row-major images.
    """

    def __init__(self, state_size: int, image_size=(32, 32),
                 patch_size: int = 8, channels: int = 3,
                 embed_dim: int = 256, n_heads: int = 4, n_layers: int = 4,
                 mlp_ratio: int = 4, dropout_rate: float = 0.0,
                 activation: Union[str, Callable] = "gelu"):
        if isinstance(image_size, int):
            image_size = (image_size, image_size)
        H, W = image_size
        if H % patch_size or W % patch_size:
            raise ValueError(
                f"image_size {image_size} must be divisible by "
                f"patch_size {patch_size}")
        super().__init__(state_size, H * W * channels,
                         embed_dim=embed_dim, n_heads=n_heads,
                         n_layers=n_layers, mlp_ratio=mlp_ratio,
                         chunk=patch_size * patch_size * channels,
                         dropout_rate=dropout_rate, activation=activation)
        if self.pad != 0 or self.n_tokens != (H // patch_size) * \
                (W // patch_size):
            raise ValueError(
                f"parent tokenization diverged from the patch grid: pad="
                f"{self.pad}, n_tokens={self.n_tokens} (expected 0 and "
                f"{(H // patch_size) * (W // patch_size)})")
        self.image_size = (H, W)
        self.patch_size = patch_size
        self.channels = channels

    def _patchify(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) or flat (B, H*W*C) -> (B, T, patch²·C) tokens."""
        B = x.shape[0]
        H, W = self.image_size
        p, C = self.patch_size, self.channels
        if x.dim() == 2:
            if x.shape[1] != H * W * C:
                raise ValueError(
                    f"ViTEncoder configured for {(H, W, C)} images "
                    f"({H * W * C} flat features), got flat width "
                    f"{x.shape[1]}")
            x = x.reshape(B, H, W, C)
        elif tuple(x.shape[1:]) != (H, W, C):
            raise ValueError(
                f"ViTEncoder configured for {(H, W, C)} images, got "
                f"{tuple(x.shape[1:])}")
        x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, (H // p) * (W // p), p * p * C)

    def apply(self, params, state, x, train=False, generator=None):
        return super().apply(params, state, self._patchify(x), train=train,
                             generator=generator)
