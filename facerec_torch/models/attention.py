"""AttentionNet (counterpart of ``facerec_tpu/models/attention.py``): a
ResNet-18 trunk -> self-attention over its H x W positions with a learned
residual scalar ``gamma`` (init 0) -> spatial attention (channel mean and
max -> 7x7 conv -> sigmoid mask) -> global average pool -> FC num_classes.

The JAX model works on NHWC maps; here the maps are NCHW, and the positions
are flattened as ``flatten(2)`` orders them, row-major over (h, w), which is
the order of JAX's ``reshape(b, h * w, c)`` of an NHWC map. The energy
``q . k`` is not scaled by 1/sqrt(d), as in the JAX model. No dropout,
whatever rate the factory passes."""

from __future__ import annotations

import torch
import torch.nn as nn

from facerec_torch.models.resnet import ResNet18


class SpatialAttention(nn.Module):
    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, H, W]
        pooled = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.conv(pooled))


class AttentionModule(nn.Module):
    def __init__(self, in_channels: int = 512, reduction_ratio: int = 8):
        super().__init__()
        red = in_channels // reduction_ratio
        self.query = nn.Conv2d(in_channels, red, 1)
        self.key = nn.Conv2d(in_channels, red, 1)
        self.value = nn.Conv2d(in_channels, in_channels, 1)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.spatial_attention = SpatialAttention()

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, H, W]
        b, c, h, w = x.shape
        q = self.query(x).flatten(2)  # [B, red, HW]
        k = self.key(x).flatten(2)
        v = self.value(x).flatten(2)  # [B, C, HW]
        attn = torch.softmax(q.transpose(1, 2) @ k, dim=-1)  # [B, HW(q), HW(k)]
        out = (v @ attn.transpose(1, 2)).view(b, c, h, w)
        return self.spatial_attention(self.gamma * out + x)


class AttentionNet(nn.Module):
    def __init__(self, num_classes: int = 18, dropout_rate: float = 0.25):
        super().__init__()
        self.backbone = ResNet18()
        self.attention = AttentionModule(512)
        self.fc = nn.Linear(512, num_classes)
        self.dropout_rate = dropout_rate  # kept for the factory; the JAX model applies none

    def embed(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = self.backbone.features(x_nhwc.permute(0, 3, 1, 2))
        return self.attention(x).mean(dim=(2, 3))  # [B, 512]

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.fc(self.embed(x))
