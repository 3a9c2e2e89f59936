"""BaselineNet (counterpart of ``facerec_tpu/models/baseline.py``): a
3-block CNN classifier. conv3x3-BN-ReLU-maxpool x3 (32/64/128 channels) ->
global average pool -> FC 512 (ReLU, the embedding) -> dropout -> FC
num_classes. NHWC input."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from facerec_torch.models.arcface import dropout
from facerec_torch.models.resnet import BatchNorm


class BaselineNet(nn.Module):
    def __init__(self, num_classes: int = 18, dropout_rate: float = 0.5):
        super().__init__()
        for i, (cin, cout) in enumerate(((3, 32), (32, 64), (64, 128)), start=1):
            setattr(self, f"conv{i}", nn.Conv2d(cin, cout, 3, padding=1))
            setattr(self, f"bn{i}", BatchNorm(cout, eps=1e-5))
        self.fc1 = nn.Linear(128, 512)
        self.fc2 = nn.Linear(512, num_classes)
        self.dropout_rate = dropout_rate

    def embed(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """512-d pre-classifier features."""
        x = x_nhwc.permute(0, 3, 1, 2)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
            x = F.max_pool2d(x, 2, 2)
        return F.relu(self.fc1(x.mean(dim=(2, 3))))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """Class logits; in training mode dropout draws from ``generator``."""
        e = self.embed(x)
        if self.training:
            e = dropout(e, self.dropout_rate, generator)
        return self.fc2(e)
