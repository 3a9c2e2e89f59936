"""InceptionResnetV1 (FaceNet), the demo's second embedder (counterpart of
``facerec_tpu/models/facenet.py``).

stem -> 5 x Block35 -> Mixed_6a -> 10 x Block17 -> Mixed_7a -> 5 x Block8
-> Block8 (no ReLU) -> spatial mean -> Linear(1792, 512, no bias) ->
BatchNorm (eps 1e-3) is the 512-d embedding, as in facenet-pytorch. The
module names and NCHW parameter layouts are facenet-pytorch's
(``conv2d_1a.conv``, ``repeat_1.0.branch1.1.bn``, ``mixed_7a.branch2.2``,
``block8.conv2d``, ``last_linear``, ``last_bn``, ``logits``), so one of its
``.pt`` state dicts loads with ``load_state_dict(strict=True)``. As there,
the last ``Block8`` adds its branch at scale 1.0; the ``repeat_3`` blocks
scale theirs by 0.20 (the JAX package scales the last one by 0.20 too,
ROADMAP section 3). Maxpools are 3 x 3, stride 2, floor mode.

Input: NHWC crops of 160 px; ``fixed_standardize`` maps 0..255 to
(x - 127.5) / 128, facenet-pytorch's ``fixed_image_standardization``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from facerec_torch import resolve_device
from facerec_torch.models.arcface import init_like_flax
from facerec_torch.models.resnet import BatchNorm
from facerec_torch.ops.arcface import l2_normalize

__all__ = ["BasicConv2d", "Block35", "Block17", "Block8", "Mixed6a", "Mixed7a",
           "InceptionResnetV1", "fixed_standardize", "init_like_flax", "build_facenet_embedder"]


class BasicConv2d(nn.Module):
    """Convolution without bias, BatchNorm (eps 1e-3), ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = BatchNorm(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class Block35(nn.Module):
    def __init__(self, scale: float = 0.17):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(256, 32, 1)
        self.branch1 = nn.Sequential(BasicConv2d(256, 32, 1), BasicConv2d(32, 32, 3, padding=1))
        self.branch2 = nn.Sequential(BasicConv2d(256, 32, 1), BasicConv2d(32, 32, 3, padding=1),
                                     BasicConv2d(32, 32, 3, padding=1))
        self.conv2d = nn.Conv2d(96, 256, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)], dim=1)
        return F.relu(x + self.scale * self.conv2d(out))


class Block17(nn.Module):
    def __init__(self, scale: float = 0.10):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(896, 128, 1)
        self.branch1 = nn.Sequential(BasicConv2d(896, 128, 1),
                                     BasicConv2d(128, 128, (1, 7), padding=(0, 3)),
                                     BasicConv2d(128, 128, (7, 1), padding=(3, 0)))
        self.conv2d = nn.Conv2d(256, 896, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.cat([self.branch0(x), self.branch1(x)], dim=1)
        return F.relu(x + self.scale * self.conv2d(out))


class Block8(nn.Module):
    def __init__(self, scale: float = 0.20, no_relu: bool = False):
        super().__init__()
        self.scale = scale
        self.no_relu = no_relu
        self.branch0 = BasicConv2d(1792, 192, 1)
        self.branch1 = nn.Sequential(BasicConv2d(1792, 192, 1),
                                     BasicConv2d(192, 192, (1, 3), padding=(0, 1)),
                                     BasicConv2d(192, 192, (3, 1), padding=(1, 0)))
        self.conv2d = nn.Conv2d(384, 1792, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.cat([self.branch0(x), self.branch1(x)], dim=1)
        out = x + self.scale * self.conv2d(out)
        return out if self.no_relu else F.relu(out)


class Mixed6a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(256, 384, 3, stride=2)
        self.branch1 = nn.Sequential(BasicConv2d(256, 192, 1), BasicConv2d(192, 192, 3, padding=1),
                                     BasicConv2d(192, 256, 3, stride=2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), F.max_pool2d(x, 3, 2)], dim=1)


class Mixed7a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = nn.Sequential(BasicConv2d(896, 256, 1), BasicConv2d(256, 384, 3, stride=2))
        self.branch1 = nn.Sequential(BasicConv2d(896, 256, 1), BasicConv2d(256, 256, 3, stride=2))
        self.branch2 = nn.Sequential(BasicConv2d(896, 256, 1), BasicConv2d(256, 256, 3, padding=1),
                                     BasicConv2d(256, 256, 3, stride=2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionResnetV1(nn.Module):
    """512-d face embedder. ``embed`` returns unit f32 embeddings of NHWC
    0..255 crops, standardised first by ``fixed_standardize``; ``logits``
    adds the classification head when ``num_classes`` > 0 (facenet-pytorch's
    VGGFace2 file has one of 8,631 classes). Inference only: facenet-pytorch's
    dropout (0.6) is a no-op at eval and is left out."""

    def __init__(self, repeats: tuple[int, int, int] = (5, 10, 5), num_classes: int = 0):
        super().__init__()
        self.conv2d_1a = BasicConv2d(3, 32, 3, stride=2)
        self.conv2d_2a = BasicConv2d(32, 32, 3)
        self.conv2d_2b = BasicConv2d(32, 64, 3, padding=1)
        self.conv2d_3b = BasicConv2d(64, 80, 1)
        self.conv2d_4a = BasicConv2d(80, 192, 3)
        self.conv2d_4b = BasicConv2d(192, 256, 3, stride=2)
        self.repeat_1 = nn.Sequential(*[Block35() for _ in range(repeats[0])])
        self.mixed_6a = Mixed6a()
        self.repeat_2 = nn.Sequential(*[Block17() for _ in range(repeats[1])])
        self.mixed_7a = Mixed7a()
        self.repeat_3 = nn.Sequential(*[Block8() for _ in range(repeats[2])])
        self.block8 = Block8(scale=1.0, no_relu=True)
        self.last_linear = nn.Linear(1792, 512, bias=False)
        self.last_bn = BatchNorm(512, eps=1e-3)
        if num_classes > 0:
            self.logits = nn.Linear(512, num_classes)

    def features(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """[N, S, S, 3] 0..255 -> the [N, 512] pre-normalisation embedding,
        in the parameters' dtype."""
        dt = self.last_linear.weight.dtype
        x = fixed_standardize(x_nhwc).to(dt).permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        x = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.conv2d_4b(self.conv2d_4a(self.conv2d_3b(x)))
        x = self.mixed_7a(self.repeat_2(self.mixed_6a(self.repeat_1(x))))
        x = self.block8(self.repeat_3(x)).mean(dim=(2, 3))
        return self.last_bn(self.last_linear(x))

    def embed(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.features(x_nhwc).float())

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        return self.embed(x_nhwc)

    def logits(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        # the head is registered as the module ``logits`` (facenet-pytorch's
        # key), which this method's name shadows as an attribute
        head = self._modules.get("logits")
        if head is None:
            raise ValueError("this InceptionResnetV1 has no classification head (num_classes 0)")
        return head(self.features(x_nhwc))


def fixed_standardize(x: torch.Tensor) -> torch.Tensor:
    """facenet-pytorch's ``fixed_image_standardization``, in f32."""
    return (x.float() - 127.5) / 128.0


def _repeats(state: Mapping[str, torch.Tensor]) -> tuple[int, int, int]:
    """The block counts of a state dict (``repeat_1.4.conv2d.weight`` ... )."""
    def count(name: str) -> int:
        return len({k.split(".")[1] for k in state if k.startswith(f"{name}.")})
    return count("repeat_1"), count("repeat_2"), count("repeat_3")


def build_facenet_embedder(weights: str | Path | Mapping[str, torch.Tensor] | None = None, *,
                           repeats: tuple[int, int, int] = (5, 10, 5),
                           dtype: torch.dtype = torch.bfloat16, seed: int = 1,
                           device: str | torch.device | None = None) -> InceptionResnetV1:
    """An eval-mode InceptionResnetV1 on ``device`` (default: the CUDA card)
    whose ``embed(crops [N, S, S, 3], 0..255) -> [N, 512]`` standardises and
    embeds, the interface ``FacePipeline`` calls. ``weights``: a
    facenet-pytorch state dict, or the path of a torch-pickled one
    (``models.convert.load_torch_state_dict`` unwraps ``state_dict`` and
    ``model_state_dict``); the block counts and the head come from it.
    Without weights they are random from ``seed`` at ``repeats``. The
    parameters are cast to ``dtype``, as ``build_embedder`` casts ArcFace's."""
    dev = resolve_device(device)
    if weights is not None:
        if not isinstance(weights, Mapping):
            from facerec_torch.models.convert import load_torch_state_dict

            weights = load_torch_state_dict(weights)
        head = weights.get("logits.weight")
        model = InceptionResnetV1(_repeats(weights),
                                  num_classes=0 if head is None else head.shape[0])
        model.load_state_dict(weights)
    else:
        model = InceptionResnetV1(repeats)
        init_like_flax(model, torch.Generator().manual_seed(seed))
    model = model.to(device=dev, dtype=dtype).eval()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
