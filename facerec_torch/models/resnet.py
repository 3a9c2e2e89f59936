"""ResNet-18 trunk, eval mode (counterpart of ``facerec_tpu/models/resnet.py``).

State-dict keys follow torchvision (``conv1``, ``bn1``,
``layer{1-4}.{0,1}.{conv1,bn1,conv2,bn2,downsample.0,downsample.1}``).
Public inputs are NHWC like the JAX model; inside, the tensor is NCHW in
``channels_last`` memory, the layout cuDNN prefers.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout, eps=1e-5)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout, eps=1e-5)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride, bias=False), nn.BatchNorm2d(cout, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idn = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + idn)


class ResNet18(nn.Module):
    """``features`` -> [B, 8w, H/32, W/32] (NCHW); ``pooled`` takes NHWC
    input and returns the [B, 8w] global-average-pooled vector."""

    def __init__(self, width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(width, eps=1e-5)
        chans = [width, width * 2, width * 4, width * 8]
        for li, c in enumerate(chans, start=1):
            cin = width if li == 1 else chans[li - 2]
            stride = 1 if li == 1 else 2
            setattr(self, f"layer{li}", nn.Sequential(BasicBlock(cin, c, stride),
                                                      BasicBlock(c, c)))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return x

    def pooled(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        return self.features(x).mean(dim=(2, 3))
