"""ArcFace embedding network, eval path (counterpart of
``facerec_tpu/models/arcface.py`` ``ArcFaceNet.embed``): ResNet-18 GAP ->
Dense(512, no bias) -> BatchNorm (eps 1e-5) -> L2 normalise in f32.

The serve path feeds raw 0..255 crops with no input normalisation, as the
JAX serve path does.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn as nn

from facerec_torch import resolve_device
from facerec_torch.models.resnet import ResNet18
from facerec_torch.ops.arcface import l2_normalize


class ArcFaceNet(nn.Module):
    def __init__(self, embedding_dim: int = 512, width: int = 64):
        super().__init__()
        self.backbone = ResNet18(width)
        self.embedding = nn.Linear(width * 8, embedding_dim, bias=False)
        self.bn = nn.BatchNorm1d(embedding_dim, eps=1e-5)

    def embed(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """[N, S, S, 3] crops (any float dtype; cast to the model's) ->
        unit f32 embeddings [N, D]."""
        dt = self.embedding.weight.dtype
        x = self.bn(self.embedding(self.backbone.pooled(x_nhwc.to(dt))))
        return l2_normalize(x.float())

    forward = embed


def init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with Flax's defaults: convolution and dense
    kernels LeCun-normal (std 1/sqrt(fan_in)), BatchNorm scale 1, bias 0,
    running mean 0, running variance 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                m.reset_parameters()


def build_embedder(variables: Mapping[str, Any] | None = None, *, embedding_dim: int = 512,
                   width: int = 64, dtype: torch.dtype = torch.bfloat16, seed: int = 1,
                   device: str | torch.device | None = None) -> ArcFaceNet:
    """An eval-mode ArcFace embedder on ``device`` (default: the CUDA card).
    ``variables``: a JAX ``{"params", "batch_stats"}`` tree of arrays,
    carried over by ``facerec_torch.convert.from_jax``; without it the weights
    are random from ``seed``."""
    dev = resolve_device(device)
    model = ArcFaceNet(embedding_dim, width)
    if variables is not None:
        from facerec_torch.convert import from_jax

        model.load_state_dict(from_jax(variables, "arcface"))
    else:
        init_like_flax(model, torch.Generator().manual_seed(seed))
    model = model.to(device=dev, dtype=dtype).eval()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
