"""ResNet-18 trunk (counterpart of ``facerec_tpu/models/resnet.py``).

State-dict keys follow torchvision (``conv1``, ``bn1``,
``layer{1-4}.{0,1}.{conv1,bn1,conv2,bn2,downsample.0,downsample.1}``).
Public inputs are NHWC like the JAX model; inside, the tensor is NCHW in
``channels_last`` memory on the card, the layout cuDNN prefers.

In training mode (``module.train()``) BatchNorm normalises with the
batch's statistics and updates the running ones as Flax's ``BatchNorm``
does (``BatchNorm`` below); in eval mode it uses the running statistics.
Inside a data-parallel step (``parallel.mesh.data_parallel``) the batch is
the global one: the statistics are taken over the data ranks, as GSPMD
computes a Flax BatchNorm's over the sharded batch (``global_batch_norm``:
on the card the native fused kernels of ``nn.SyncBatchNorm``, on the CPU
the plain version ``global_batch_norm_plain``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from facerec_torch.parallel.collectives import all_reduce_, gather, psum
from facerec_torch.parallel.mesh import Mesh, sharded_data_mesh
from facerec_torch.utils import profiling


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
            y, mean, var = global_batch_norm(x, self.weight, self.bias, self.eps, mesh)
        else:
            y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None,
                                                      True, 0.0, self.eps)
            var = _biased_var(invstd, self.eps, self.running_mean.dtype)
        with torch.no_grad():
            dt = self.running_mean.dtype
            self.running_mean.lerp_(mean.to(dt), 1.0 - self.MOMENTUM)
            self.running_var.lerp_(var.to(dt), 1.0 - self.MOMENTUM)
            self.num_batches_tracked.add_(1)
        return y


def _biased_var(invstd: torch.Tensor, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """The biased variance from the native kernels' 1 / sqrt(var + eps)."""
    with torch.no_grad():
        return invstd.to(dtype).pow(-2).sub_(eps)


def global_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                      mesh: Mesh) -> tuple[torch.Tensor, ...]:
    """Train mode over the global batch of a data-parallel step, whose data
    ranks each hold a slice of one shape: (y, mean, biased variance). On
    CUDA tensors the native fused kernels (``_GlobalBatchNorm``), on CPU
    tensors the plain version ``global_batch_norm_plain``."""
    if not x.is_cuda:
        return global_batch_norm_plain(x, weight, bias, eps, mesh)
    group = mesh.group(mesh.data_axis)
    y, mean, invstd = _GlobalBatchNorm.apply(x, weight, bias, eps, group,
                                             mesh.size(mesh.data_axis))
    return y, mean, _biased_var(invstd, eps, weight.dtype)


def global_batch_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                            eps: float, mesh: Mesh) -> tuple[torch.Tensor, ...]:
    """Plain version of ``global_batch_norm``, in f32: the mean from the sum
    over the data ranks, then the biased variance from the sum of squares
    about that mean over the data ranks, each sum with its gradient. Two
    passes, as the native kernel's variance: Flax's one-pass E[x^2] - E[x]^2
    cancels where the mean is large against the spread. Every rank's slice
    has the same shape, so the count is the local one times the data size."""
    dims = [0, *range(2, x.ndim)]
    shape = [1, -1] + [1] * (x.ndim - 2)
    count = x.numel() // x.shape[1] * mesh.size(mesh.data_axis)
    xf = x.float()
    mean = psum(xf.sum(dims), mesh, mesh.data_axis) / count
    centered = xf - mean.view(shape)
    var = psum((centered * centered).sum(dims), mesh, mesh.data_axis) / count
    y = centered * torch.rsqrt(var + eps).view(shape)
    y = y * weight.view(shape) + bias.view(shape)
    return y.to(x.dtype), mean, var


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the data ranks on the native fused kernels
    of ``nn.SyncBatchNorm`` (in JAX a Flax BatchNorm that XLA compiles, with
    no Pallas kernel). Forward: each rank's mean and 1 / sqrt(var + eps)
    (``batch_norm_stats``, Welford's update in f32), one all-gather of both,
    the global ones (``batch_norm_gather_stats_with_counts``), the
    normalisation (``batch_norm_elemt``). Backward: each rank's sums of dy
    and dy (x - mean) with the local weight and bias gradients
    (``batch_norm_backward_reduce``), one all-reduce of the two sums, the
    input gradient (``batch_norm_backward_elemt``); a bf16 input is reduced
    in an f32 copy. The weight and bias gradients stay local, for the train
    step's gradient sum. The counts are fills (every rank's slice has the
    same shape), so the step holds no copy from the host and can be
    captured. x: channels_last [N, C, H, W] or [N, C], f32 or bf16 with f32
    weight and bias. ``group`` None is one rank (no collective). The
    all-gather is the device span ``bn.gather`` (``utils.profiling``),
    numbered by its order in the forward pass."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group, n):
        if not x.is_contiguous(memory_format=torch.channels_last):
            x = x.contiguous()
        c = x.shape[1]
        mean, invstd = torch.batch_norm_stats(x, eps)
        local = torch.cat([mean, invstd])
        if group is None:
            every = local[None]
        else:  # the span holds the wait for the slowest rank
            with profiling.device_span("bn.gather", x.device, numbered=True):
                every = gather(local, group, n)
        count = x.numel() // c
        # the kernel reads the counts in the running statistics' dtype (the
        # input's without them): scratch f32 ones, left as they are by a
        # momentum of 0, keep the counts exact under bf16 inputs
        scratch = torch.zeros(2, c, dtype=mean.dtype, device=x.device)
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, every[:, :c], every[:, c:], scratch[0], scratch[1], 0.0, eps,
            torch.full((n,), float(count), dtype=mean.dtype, device=x.device))
        ctx.save_for_backward(x, weight, mean, invstd,
                              torch.full((n,), count, dtype=torch.int32, device=x.device))
        ctx.group = group
        ctx.mark_non_differentiable(mean, invstd)
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps), mean, invstd

    @staticmethod
    def backward(ctx, dy, _mean, _invstd):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        if not dy.is_contiguous(memory_format=torch.channels_last):
            dy = dy.contiguous()
        # the fused reduce of a bf16 channels_last input rounds its sums to
        # bf16 (the weight and bias gradients 3.6e-3 off f64 in L2 on the
        # card): it reduces f32 copies instead
        xr, dyr = (x, dy) if x.dtype == torch.float32 else (x.float(), dy.float())
        sum_dy, sum_dy_xmu, dw, db = torch.batch_norm_backward_reduce(
            dyr, xr, mean, invstd, weight, True, True, True)
        del xr, dyr
        if ctx.group is not None:
            both = all_reduce_(torch.cat([sum_dy, sum_dy_xmu]), ctx.group)
            sum_dy, sum_dy_xmu = both.split(sum_dy.shape[0])
        dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight.to(mean.dtype), sum_dy,
                                             sum_dy_xmu, counts)
        return dx, dw, db, None, None, None


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
