"""HybridNet (counterpart of ``facerec_tpu/models/hybrid.py``): a ResNet-18
trunk -> its H x W positions as tokens of dim 512 (batch-major, row-major
over (h, w), as JAX reshapes its NHWC map) + a learned positional table
(49 x 512, init normal(0.02)) -> one pre-LN transformer block (4 heads,
exact-GELU FFN 2048, dropout 0.1) -> mean over tokens -> LayerNorm ->
dropout -> FC num_classes.

Flax's conventions, kept here: LayerNorm epsilon 1e-6; the attention's
query is scaled by 1/sqrt(head dim) before the product; its dropout falls
on the attention weights with one [S, S] mask shared by every batch row and
head (``broadcast_dropout``). The block's dropout is 0.1 whatever the net's
``dropout_rate``. For inputs other than 224 px the positional table is
resized along its 49 rows with the antialiased bilinear rule of
``jax.image.resize(..., "linear")``."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from facerec_torch.models.arcface import dropout
from facerec_torch.models.resnet import ResNet18
from facerec_torch.ops.image import resize_bilinear

LN_EPS = 1e-6  # Flax's nn.LayerNorm


class MultiHeadAttention(nn.Module):
    """Flax's ``MultiHeadDotProductAttention`` on [B, S, D] as explicit
    products. Each projection is a [D, D] ``nn.Linear``: Flax's [D, H, D/H]
    query/key/value kernels and its [H, D/H, D] output kernel, flattened."""

    def __init__(self, dim: int = 512, num_heads: int = 4, dropout_rate: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        b, s, d = x.shape
        heads = lambda t: t.view(b, s, self.num_heads, d // self.num_heads).transpose(1, 2)  # noqa: E731
        q = heads(self.query(x)) / math.sqrt(d // self.num_heads)
        k, v = heads(self.key(x)), heads(self.value(x))
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)  # [B, H, S, S]
        if self.training:
            w = dropout(w, self.dropout_rate, generator, shape=(s, s))
        return self.out((w @ v).transpose(1, 2).reshape(b, s, d))


class TransformerBlock(nn.Module):
    def __init__(self, embed_dim: int = 512, num_heads: int = 4, ff_dim: int = 2048,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.norm1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.attention = MultiHeadAttention(embed_dim, num_heads, dropout_rate)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.ff1 = nn.Linear(embed_dim, ff_dim)
        self.ff2 = nn.Linear(ff_dim, embed_dim)
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = x + self.attention(self.norm1(x), generator)
        y = F.gelu(self.ff1(self.norm2(x)))  # exact (erf)
        if self.training:
            y = dropout(y, self.dropout_rate, generator)
        y = self.ff2(y)
        if self.training:
            y = dropout(y, self.dropout_rate, generator)
        return x + y

    def set_dropout(self, rate: float) -> None:
        """One rate for the attention weights and both FFN dropouts."""
        self.dropout_rate = self.attention.dropout_rate = rate


class HybridNet(nn.Module):
    def __init__(self, num_classes: int = 18, fdim: int = 512, seq_len: int = 49,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.backbone = ResNet18(fdim // 8)
        self.pos_encoding = nn.Parameter(torch.zeros(seq_len, fdim))
        self.transformer = TransformerBlock(fdim)
        self.norm = nn.LayerNorm(fdim, eps=LN_EPS)
        self.fc = nn.Linear(fdim, num_classes)
        self.dropout_rate = dropout_rate

    def positions(self, seq_len: int) -> torch.Tensor:
        """The positional table at ``seq_len`` rows."""
        pos = self.pos_encoding
        if seq_len == pos.shape[0]:
            return pos
        return resize_bilinear(pos[None, :, :, None], (seq_len, pos.shape[1]))[0, :, :, 0]

    def embed(self, x_nhwc: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        f = self.backbone.features(x_nhwc.permute(0, 3, 1, 2))  # [B, 512, H, W]
        tokens = f.flatten(2).transpose(1, 2)  # [B, HW, 512]
        tokens = self.transformer(tokens + self.positions(tokens.shape[1]), generator)
        return self.norm(tokens.mean(dim=1))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        e = self.embed(x, generator)
        if self.training:
            e = dropout(e, self.dropout_rate, generator)
        return self.fc(e)
