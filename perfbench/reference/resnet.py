"""Plain ResNet-18 ArcFace embedder (He et al. 2016; Deng et al. 2019): a
ResNet-18 trunk (64-128-256-512, BasicBlocks, eval-mode BatchNorm with eps
1e-5), global average pool, a 512-d linear projection without bias,
BatchNorm, L2 normalisation. Input: raw 0..255 NHWC crops, as served.
Parameters by torchvision's names under ``backbone.`` (``backbone.conv1``,
``backbone.layer1.0.bn1`` ...), then ``embedding``, ``bn`` and the class
centres ``arc_weight`` (unused in serving)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.precision import Precision

WIDTHS = (64, 128, 256, 512)


def _bn_shapes(prefix, c):
    return {f"{prefix}.weight": (c,), f"{prefix}.bias": (c,), f"{prefix}.running_mean": (c,),
            f"{prefix}.running_var": (c,), f"{prefix}.num_batches_tracked": ()}


def param_shapes(embedding_dim: int = 512, num_classes: int = 18) -> dict[str, tuple]:
    s = {"backbone.conv1.weight": (64, 3, 7, 7), **_bn_shapes("backbone.bn1", 64)}
    cin = 64
    for li, c in enumerate(WIDTHS, start=1):
        for bi in range(2):
            p = f"backbone.layer{li}.{bi}"
            i = cin if bi == 0 else c
            s[f"{p}.conv1.weight"] = (c, i, 3, 3)
            s.update(_bn_shapes(f"{p}.bn1", c))
            s[f"{p}.conv2.weight"] = (c, c, 3, 3)
            s.update(_bn_shapes(f"{p}.bn2", c))
            if bi == 0 and li > 1:
                s[f"{p}.downsample.0.weight"] = (c, i, 1, 1)
                s.update(_bn_shapes(f"{p}.downsample.1", c))
        cin = c
    s["embedding.weight"] = (embedding_dim, 512)
    s.update(_bn_shapes("bn", embedding_dim))
    s["arc_weight"] = (num_classes, embedding_dim)
    return s


def batch_norm(x, w, prefix, eps):
    shape = [1, -1] + [1] * (x.ndim - 2)
    mean = w[f"{prefix}.running_mean"].float().view(shape)
    var = w[f"{prefix}.running_var"].float().view(shape)
    scale = w[f"{prefix}.weight"].float().view(shape)
    return (x - mean) / torch.sqrt(var + eps) * scale + w[f"{prefix}.bias"].float().view(shape)


def _block(p, w, x, prefix, stride):
    y = p.conv2d(x, w[f"{prefix}.conv1.weight"], stride=stride, padding=1)
    y = F.relu(batch_norm(y, w, f"{prefix}.bn1", 1e-5))
    y = batch_norm(p.conv2d(y, w[f"{prefix}.conv2.weight"], padding=1), w, f"{prefix}.bn2", 1e-5)
    if f"{prefix}.downsample.0.weight" in w:
        x = batch_norm(p.conv2d(x, w[f"{prefix}.downsample.0.weight"], stride=stride), w,
                       f"{prefix}.downsample.1", 1e-5)
    return F.relu(y + x)


def embed(p: Precision, w: dict, crops: torch.Tensor) -> torch.Tensor:
    """[N, S, S, 3] 0..255 -> unit [N, D] f32."""
    x = crops.float().permute(0, 3, 1, 2)
    x = p.conv2d(x, w["backbone.conv1.weight"], stride=2, padding=3)
    x = F.relu(batch_norm(x, w, "backbone.bn1", 1e-5))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for li in range(1, 5):
        x = _block(p, w, x, f"backbone.layer{li}.0", 1 if li == 1 else 2)
        x = _block(p, w, x, f"backbone.layer{li}.1", 1)
    x = p.linear(x.mean(dim=(2, 3)), w["embedding.weight"])
    x = batch_norm(x, w, "bn", 1e-5)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
