"""SiameseNet (counterpart of ``facerec_tpu/models/siamese.py``): a twin
metric-learning network with shared weights.

Trunk: conv7x7/2(64)-BN-ReLU-maxpool; [conv3x3(128)-BN-ReLU] x2-maxpool;
[conv3x3(256)-BN-ReLU] x2-maxpool; conv3x3(512)-BN-ReLU -> adaptive average
pool to 6x6. Head: dropout(0.3) -> FC 1024-BN-ReLU -> dropout(0.2) -> FC
512-BN-ReLU -> FC 256 -> L2 normalise.

As in the JAX model, the twin pass is ONE forward over ``cat([xa, xb])``,
so that training-mode BatchNorm takes its statistics over the 2B images,
and the 6x6 map is flattened in NHWC order (so ``fc1``'s 18,432 input rows
are the JAX kernel's, unpermuted)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from facerec_torch.models.arcface import dropout
from facerec_torch.models.resnet import BatchNorm
from facerec_torch.ops.arcface import l2_normalize

CONV_SPECS = ((64, 7, 2), (128, 3, 1), (128, 3, 1), (256, 3, 1), (256, 3, 1), (512, 3, 1))
POOL_AFTER = (0, 2, 4)
POOL_HW = (6, 6)


def _adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """NCHW adaptive average pool: bin i spans [floor(i H / O), ceil((i + 1)
    H / O)), the bins of each of the JAX model's branches (equal size,
    reshape-mean when O divides H, masked means otherwise, where bins
    overlap or repeat)."""
    return F.adaptive_avg_pool2d(x, out_hw)


class SiameseNet(nn.Module):
    def __init__(self, embedding_dim: int = 256):
        super().__init__()
        cin = 3
        for i, (ch, k, s) in enumerate(CONV_SPECS):
            setattr(self, f"conv{i}", nn.Conv2d(cin, ch, k, stride=s, padding=k // 2))
            setattr(self, f"conv_bn{i}", BatchNorm(ch, eps=1e-5))
            cin = ch
        self.fc1 = nn.Linear(cin * POOL_HW[0] * POOL_HW[1], 1024)
        self.fc_bn1 = BatchNorm(1024, eps=1e-5)
        self.fc2 = nn.Linear(1024, 512)
        self.fc_bn2 = BatchNorm(512, eps=1e-5)
        self.fc3 = nn.Linear(512, embedding_dim)
        self.dropout_rates = (0.3, 0.2)

    def embed(self, x_nhwc: torch.Tensor, generator: torch.Generator | None = None,
              blocks: int = 1) -> torch.Tensor:
        """[N, S, S, 3] -> unit [N, 256] embeddings; ``blocks``: the number
        of batches stacked in ``x`` (2 for the twin pass), which a
        data-parallel step's dropout slices apart."""
        x = x_nhwc.permute(0, 3, 1, 2)
        for i in range(len(CONV_SPECS)):
            x = F.relu(getattr(self, f"conv_bn{i}")(getattr(self, f"conv{i}")(x)))
            if i in POOL_AFTER:
                x = F.max_pool2d(x, 2, 2)
        x = _adaptive_avg_pool(x, POOL_HW).permute(0, 2, 3, 1).flatten(1)  # NHWC order
        if self.training:
            x = dropout(x, self.dropout_rates[0], generator, blocks=blocks)
        x = F.relu(self.fc_bn1(self.fc1(x)))
        if self.training:
            x = dropout(x, self.dropout_rates[1], generator, blocks=blocks)
        x = F.relu(self.fc_bn2(self.fc2(x)))
        return l2_normalize(self.fc3(x))

    def forward(self, xa: torch.Tensor, xb: torch.Tensor,
                generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        both = self.embed(torch.cat([xa, xb]), generator, blocks=2)
        return both[: xa.shape[0]], both[xa.shape[0]:]
