"""ArcFace network (counterpart of ``facerec_tpu/models/arcface.py``):
ResNet-18 GAP -> Dense(512, no bias) -> BatchNorm (eps 1e-5) -> dropout
(train only) -> L2 normalise in f32 is the embedding. Training routes it
through the arc-margin logits against the class-centre weight
``arc_weight`` [C, D]; evaluation with labels gives cosine logits against
the same centres.

The serve path feeds raw 0..255 crops with no input normalisation, as the
JAX serve path does; the trainer feeds ImageNet-normalised images.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Mapping

import torch
import torch.nn as nn

from facerec_torch import resolve_device
from facerec_torch.models.resnet import BatchNorm, ResNet18
from facerec_torch.ops.arcface import arc_margin_logits, cosine_logits, l2_normalize
from facerec_torch.parallel.mesh import sharded_data_mesh


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            shape: tuple[int, ...] | None = None, blocks: int = 1) -> torch.Tensor:
    """Flax's ``nn.Dropout`` in train mode: keep each value with probability
    1 - rate and scale it by 1 / (1 - rate), the draws from ``generator``.
    ``shape`` draws one mask of that shape, broadcast over ``x``.

    Inside a data-parallel step (``parallel.mesh.data_parallel``) ``x`` is
    this rank's rows of the global batch: the mask of the global batch is
    drawn (every rank's generator is in the same state) and this rank's
    rows are kept, so the step draws what one process would. ``blocks``:
    ``x`` stacks that many batches along dim 0 (the siamese twin pass over
    ``cat([xa, xb])``), each sliced on its own."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a generator")
    mesh = sharded_data_mesh()
    if shape is None and mesh is not None:
        n = x.shape[0] // blocks
        full = torch.rand((blocks, mesh.size(mesh.data_axis), n, *x.shape[1:]),
                          generator=generator, device=x.device)
        keep = full[:, mesh.index(mesh.data_axis)].reshape(x.shape) >= rate
    else:
        keep = torch.rand(shape or x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class ArcFaceNet(nn.Module):
    def __init__(self, embedding_dim: int = 512, width: int = 64, *, num_classes: int = 18,
                 dropout_rate: float = 0.2, margin: float = 0.5, scale: float = 32.0,
                 easy_margin: bool = False, progressive_margin: bool = True,
                 warmup_epochs: int = 10):
        super().__init__()
        self.backbone = ResNet18(width)
        self.embedding = nn.Linear(width * 8, embedding_dim, bias=False)
        self.bn = BatchNorm(embedding_dim, eps=1e-5)
        self.arc_weight = nn.Parameter(torch.zeros(num_classes, embedding_dim))
        self.dropout_rate = dropout_rate
        self.margin = margin
        self.scale = scale
        self.easy_margin = easy_margin
        self.progressive_margin = progressive_margin
        self.warmup_epochs = warmup_epochs

    def embed(self, x_nhwc: torch.Tensor,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """[N, S, S, 3] crops (any float dtype; cast to the model's) ->
        unit f32 embeddings [N, D]. In training mode BatchNorm takes the
        batch's statistics and dropout draws from ``generator``."""
        dt = self.embedding.weight.dtype
        x = self.bn(self.embedding(self.backbone.pooled(x_nhwc.to(dt))))
        if self.training:
            x = dropout(x, self.dropout_rate, generator)
        return l2_normalize(x.float())

    def forward(self, x: torch.Tensor, labels: torch.Tensor | None = None,
                epoch: torch.Tensor | float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Training mode: arc-margin logits [N, C]; eval mode with labels:
        cosine logits [N, C]; eval mode without: the embeddings [N, D]."""
        emb = self.embed(x, generator)
        if self.training:
            if labels is None:
                raise ValueError("labels required during ArcFace training")
            logits, _ = arc_margin_logits(
                emb, self.arc_weight, labels, epoch,
                margin=self.margin, scale=self.scale, easy_margin=self.easy_margin,
                progressive=self.progressive_margin, warmup_epochs=self.warmup_epochs,
                training=True)
            return logits
        if labels is not None:
            return cosine_logits(emb, self.arc_weight)
        return emb

    def eval_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Cosine logits against the class centres (the eval classification path)."""
        return cosine_logits(self.embed(x), self.arc_weight)


def truncated_normal_(w: torch.Tensor, variance: float, generator: torch.Generator) -> None:
    """Fill ``w`` as JAX's ``variance_scaling(..., "truncated_normal")``
    draws: a normal truncated to +-2 standard deviations by the inverse CDF
    of uniforms from a CPU ``generator``, its deviation sqrt(variance) /
    0.8796 so that the truncated draw has ``variance``."""
    std = math.sqrt(variance) / 0.87962566103423978
    lo, hi = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
    w.copy_(torch.special.erfinv(2 * u - 1) * math.sqrt(2) * std)


def _variance_scaling_(w: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    """JAX's ``variance_scaling(scale, "fan_avg", "truncated_normal")`` for a
    [C, D] matrix (fan_in C, fan_out D)."""
    truncated_normal_(w, scale / ((w.shape[0] + w.shape[1]) / 2.0), generator)


def init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with Flax's defaults: convolution and dense
    kernels LeCun-normal (std 1/sqrt(fan_in); the attention's [D, D]
    projections have fan-in D, as Flax's [D, H, D/H] and [H, D/H, D]
    kernels do), biases 0, BatchNorm and LayerNorm scale 1, bias 0, running
    mean 0, running variance 1, the attention residual ``gamma`` 0 and an
    ensemble's ``weights`` 1/n; then the parameters drawn after the trunks,
    so that a trunk's weights do not depend on the class count: the hybrid's
    positional table (normal(0.02)) and ArcFace's class centres (variance
    scaling 2.0, fan_avg, truncated normal)."""
    from facerec_torch.models.attention import AttentionModule
    from facerec_torch.models.ensemble import EnsembleModel
    from facerec_torch.models.hybrid import HybridNet

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d, nn.LayerNorm)):
                m.reset_parameters()
            elif isinstance(m, AttentionModule):
                m.gamma.zero_()
            elif isinstance(m, EnsembleModel) and hasattr(m, "weights"):
                m.weights.fill_(1.0 / len(m.weights))
        for m in model.modules():
            if isinstance(m, HybridNet):
                m.pos_encoding.normal_(0.0, 0.02, generator=generator)
            elif isinstance(m, ArcFaceNet):
                _variance_scaling_(m.arc_weight, 2.0, generator)


def build_embedder(variables: Mapping[str, Any] | None = None, *, embedding_dim: int = 512,
                   width: int = 64, dtype: torch.dtype = torch.bfloat16, seed: int = 1,
                   checkpoint: str | Path | None = None,
                   device: str | torch.device | None = None) -> ArcFaceNet:
    """An eval-mode ArcFace embedder on ``device`` (default: the CUDA card).
    ``variables``: a JAX ``{"params", "batch_stats"}`` tree of arrays,
    carried over by ``facerec_torch.convert.from_jax``; ``checkpoint``: a
    checkpoint directory the port's trainer wrote (``<model_dir>/best`` or
    ``final``). The shapes come from the weights; without either the
    weights are random from ``seed``."""
    dev = resolve_device(device)
    state = None
    if variables is not None:
        from facerec_torch.convert import from_jax

        state = from_jax(variables, "arcface")
    elif checkpoint is not None:
        from facerec_torch.train.checkpoints import load_checkpoint

        path = Path(checkpoint)
        state = load_checkpoint(path.parent, path.name)["model"]
    if state is not None:
        embedding_dim, in_dim = state["embedding.weight"].shape
        model = ArcFaceNet(embedding_dim, in_dim // 8, num_classes=state["arc_weight"].shape[0])
        model.load_state_dict(state)
    else:
        model = ArcFaceNet(embedding_dim, width)
        init_like_flax(model, torch.Generator().manual_seed(seed))
    model = model.to(device=dev, dtype=dtype).eval()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
