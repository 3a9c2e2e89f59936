"""IResNet ArcFace embedder: insightface's ``iresnet`` backbones
(``recognition/arcface_torch/backbones/iresnet.py``), the LResNet100E-IR of
ArcFace (Deng et al. 2019, https://arxiv.org/abs/1801.07698) at ``layers``
(3, 13, 30, 3). The JAX package has no counterpart: this model is served
only.

At a 112 px crop: a 3 x 3 stride-1 stem conv (3 -> 64), BatchNorm, PReLU,
no max-pool; four stages of ``IBasicBlock``s at widths 64, 128, 256 and
512, the first block of each with stride 2. A block is BatchNorm ->
conv3x3 -> BatchNorm -> PReLU -> conv3x3 (strided) -> BatchNorm, added to
the identity, or to a strided 1 x 1 conv and BatchNorm where the shape
changes, with no activation after the add. The head: BatchNorm2d(512),
flatten in NCHW order (512 x 7 x 7 = 25,088 at 112 px), dropout (the
identity when served, so left out), ``fc`` (25,088 -> 512, with bias),
BatchNorm1d(512) (``features``). Every BatchNorm has eps 1e-5.

The module names are insightface's (``conv1``, ``bn1``, ``prelu``,
``layer{1..4}.{i}.{bn1,conv1,bn2,prelu,conv2,bn3,downsample.0,
downsample.1}``, ``bn2``, ``fc``, ``features``), so a ``backbone.pth`` of
its ``iresnet100`` loads with ``load_state_dict(strict=True)``.

As insightface serves it, the trunk runs in the compute dtype (bf16 here,
its autocast) and the head's ``fc`` and ``features`` in f32. Input: NHWC
RGB crops, 0..255, standardised as (x - 127.5) / 127.5.

With tracing on (``utils.profiling``), ``embed`` records the device spans
``embed.stem``, ``embed.stage1`` to ``embed.stage4`` and ``embed.head``;
inside the serve step they nest in ``serve.step.embed``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import torch
import torch.nn as nn

from facerec_torch import resolve_device
from facerec_torch.models.arcface import init_like_flax
from facerec_torch.models.resnet import BatchNorm
from facerec_torch.ops.arcface import l2_normalize
from facerec_torch.utils import profiling

__all__ = ["IBasicBlock", "IResNet", "LAYERS", "standardize", "flatten_nchw",
           "build_iresnet_embedder"]

LAYERS = (3, 13, 30, 3)  # iresnet100
WIDTHS = (64, 128, 256, 512)


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class IBasicBlock(nn.Module):
    """insightface's ``IBasicBlock``: BN -> conv3x3 -> BN -> PReLU ->
    conv3x3 (``stride``) -> BN, plus the identity or ``downsample``."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.bn1 = BatchNorm(cin, eps=1e-5)
        self.conv1 = _conv3x3(cin, cout)
        self.bn2 = BatchNorm(cout, eps=1e-5)
        self.prelu = nn.PReLU(cout)
        self.conv2 = _conv3x3(cout, cout, stride)
        self.bn3 = BatchNorm(cout, eps=1e-5)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                                            BatchNorm(cout, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(self.bn1(x))))))
        return out + (x if self.downsample is None else self.downsample(x))


class IResNet(nn.Module):
    """The embedder; ``embed(crops [N, crop, crop, 3], 0..255)`` gives unit
    f32 embeddings [N, ``embedding_dim``] (module docstring). ``fc`` takes
    512 x (crop / 16)^2 features."""

    def __init__(self, layers: tuple[int, ...] = LAYERS, embedding_dim: int = 512,
                 crop: int = 112):
        super().__init__()
        if crop % 16:
            raise ValueError(f"the crop must be a multiple of 16 px, not {crop}")
        self.conv1 = _conv3x3(3, WIDTHS[0])
        self.bn1 = BatchNorm(WIDTHS[0], eps=1e-5)
        self.prelu = nn.PReLU(WIDTHS[0])
        cin = WIDTHS[0]
        for i, (n, c) in enumerate(zip(layers, WIDTHS), start=1):
            blocks = [IBasicBlock(cin, c, 2)] + [IBasicBlock(c, c) for _ in range(n - 1)]
            setattr(self, f"layer{i}", nn.Sequential(*blocks))
            cin = c
        self.bn2 = BatchNorm(cin, eps=1e-5)
        self.fc = nn.Linear(cin * (crop // 16) ** 2, embedding_dim)
        self.features = BatchNorm(embedding_dim, eps=1e-5)

    def embed(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        dev = x_nhwc.device
        with profiling.device_span("embed.stem", dev):
            # NCHW view of the NHWC crops: channels_last memory, as cuDNN takes it
            x = standardize(x_nhwc).to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
            x = self.prelu(self.bn1(self.conv1(x)))
        for i in range(1, 5):
            with profiling.device_span(f"embed.stage{i}", dev):
                x = getattr(self, f"layer{i}")(x)
        with profiling.device_span("embed.head", dev):
            x = flatten_nchw(self.bn2(x))
            x = self.features(self.fc(x.to(self.fc.weight.dtype)))
            return l2_normalize(x.float())

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        return self.embed(x_nhwc)


def standardize(x: torch.Tensor) -> torch.Tensor:
    """insightface's input: (x - 127.5) / 127.5, in f32."""
    return (x.float() - 127.5) / 127.5


def flatten_nchw(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, C * H * W] in insightface's order (C, then H,
    then W) whatever the memory layout: a channels_last map is copied into
    that order, not read as it lies."""
    return torch.flatten(x, 1)


def _layers(state: Mapping[str, torch.Tensor]) -> tuple[int, ...]:
    """The block counts of a state dict (``layer3.29.conv1.weight`` ...)."""
    return tuple(len({k.split(".")[1] for k in state if k.startswith(f"layer{i}.")})
                 for i in range(1, 5))


def build_iresnet_embedder(weights: str | Path | Mapping[str, torch.Tensor] | None = None, *,
                           layers: tuple[int, ...] = LAYERS, dtype: torch.dtype = torch.bfloat16,
                           seed: int = 1, device: str | torch.device | None = None) -> IResNet:
    """An eval-mode IResNet on ``device`` (default: the CUDA card) whose
    ``embed(crops [N, S, S, 3], 0..255) -> unit f32 [N, D]`` standardises
    and embeds, the interface ``FacePipeline`` calls. ``weights``: a state
    dict in insightface's names, or the path of a torch-pickled one
    (``models.convert.load_torch_state_dict``); the block counts, the
    embedding width and the crop come from it. Without weights they are
    random from ``seed`` at ``layers``, a 512-d embedding and 112 px. The
    trunk's parameters are cast to ``dtype``; ``fc`` and ``features`` stay
    f32, as insightface runs its head."""
    dev = resolve_device(device)
    if weights is not None:
        if not isinstance(weights, Mapping):
            from facerec_torch.models.convert import load_torch_state_dict

            weights = load_torch_state_dict(weights)
        dim, fc_in = weights["fc.weight"].shape
        side = round((fc_in // WIDTHS[-1]) ** 0.5)
        model = IResNet(_layers(weights), dim, crop=16 * side)
        model.load_state_dict(weights)
    else:
        model = IResNet(layers)
        init_like_flax(model, torch.Generator().manual_seed(seed))
    model = model.to(device=dev).eval()
    for name, child in model.named_children():
        if name not in ("fc", "features"):
            child.to(dtype)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
