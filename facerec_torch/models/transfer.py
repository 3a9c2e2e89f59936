"""ResNetTransfer (counterpart of ``facerec_tpu/models/transfer.py``): a
ResNet-18 trunk -> global average pool -> dropout -> FC num_classes. The
embedding is the pooled 512-d vector. NHWC input."""

from __future__ import annotations

import torch
import torch.nn as nn

from facerec_torch.models.arcface import dropout
from facerec_torch.models.resnet import ResNet18


class ResNetTransfer(nn.Module):
    def __init__(self, num_classes: int = 18, dropout_rate: float = 0.1):
        super().__init__()
        self.backbone = ResNet18()
        self.fc = nn.Linear(512, num_classes)
        self.dropout_rate = dropout_rate

    def embed(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """[B, 512] pooled trunk features."""
        return self.backbone.pooled(x_nhwc)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """Class logits; in training mode dropout draws from ``generator``."""
        e = self.embed(x)
        if self.training:
            e = dropout(e, self.dropout_rate, generator)
        return self.fc(e)
