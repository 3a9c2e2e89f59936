"""ResNet-18 trunk (counterpart of ``facerec_tpu/models/resnet.py``).

State-dict keys follow torchvision (``conv1``, ``bn1``,
``layer{1-4}.{0,1}.{conv1,bn1,conv2,bn2,downsample.0,downsample.1}``).
Public inputs are NHWC like the JAX model; inside, the tensor is NCHW in
``channels_last`` memory on the card, the layout cuDNN prefers.

In training mode (``module.train()``) BatchNorm normalises with the
batch's statistics and updates the running ones as Flax's ``BatchNorm``
does (``BatchNorm`` below); in eval mode it uses the running statistics.
Inside a data-parallel step (``parallel.mesh.data_parallel``) the batch is
the global one: the statistics are summed over the data ranks, as GSPMD
computes a Flax BatchNorm's over the sharded batch.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from facerec_torch.parallel.collectives import psum
from facerec_torch.parallel.mesh import sharded_data_mesh


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over dim 1 (of [N, C] or [N, C, H, W]) with Flax's train
    mode: running = 0.9 * running + 0.1 * batch, with the *biased* batch
    variance (``nn.BatchNorm2d`` keeps momentum 0.1 on the batch value too,
    but takes the unbiased variance). Same parameters and buffers as
    ``nn.BatchNorm2d``, so state dicts carry over. Eval mode is
    ``F.batch_norm`` with the running statistics. The mode is
    ``self.training``."""

    MOMENTUM = 0.9  # Flax's: the weight of the old running value

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        mesh = sharded_data_mesh()
        if mesh is not None:
            y, mean, var = self._global_batch_norm(x, mesh)
        else:
            y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None,
                                                      True, 0.0, self.eps)
        with torch.no_grad():
            dt = self.running_mean.dtype
            if mesh is None:
                # the kernel returns 1/sqrt(var + eps) of the biased variance
                var = invstd.to(dt).pow(-2).sub_(self.eps)
            var = var.to(dt)
            self.running_mean.lerp_(mean.to(dt), 1.0 - self.MOMENTUM)
            self.running_var.lerp_(var, 1.0 - self.MOMENTUM)
            self.num_batches_tracked.add_(1)
        return y

    def _global_batch_norm(self, x: torch.Tensor, mesh) -> tuple[torch.Tensor, ...]:
        """Train mode over the global batch of a data-parallel step, in f32:
        the mean from the sum over the data ranks, then the biased variance
        from the sum of squares about that mean over the data ranks, each
        sum with its gradient. Two passes, as the native kernel's variance:
        Flax's one-pass E[x^2] - E[x]^2 cancels where the mean is large
        against the spread. Every rank's slice has the same shape, so the
        count is the local one times the data size."""
        dims = [0, *range(2, x.ndim)]
        shape = [1, -1] + [1] * (x.ndim - 2)
        count = x.numel() // x.shape[1] * mesh.size(mesh.data_axis)
        xf = x.float()
        mean = psum(xf.sum(dims), mesh, mesh.data_axis) / count
        centered = xf - mean.view(shape)
        var = psum((centered * centered).sum(dims), mesh, mesh.data_axis) / count
        y = centered * torch.rsqrt(var + self.eps).view(shape)
        y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype), mean, var


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(cout, eps=1e-5)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(cout, eps=1e-5)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride, bias=False), BatchNorm(cout, eps=1e-5))

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
        self.bn1 = BatchNorm(width, eps=1e-5)
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
