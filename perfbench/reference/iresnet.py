"""Plain IResNet ArcFace embedder: insightface's ``iresnet`` backbones
(``recognition/arcface_torch/backbones/iresnet.py``; ``iresnet100`` is
``layers`` (3, 13, 30, 3), the LResNet100E-IR of Deng et al. 2019,
https://arxiv.org/abs/1801.07698).

Input: 0..255 NHWC RGB crops, standardised as (x - 127.5) / 127.5. Stem: a
3 x 3 stride-1 conv (3 -> 64, no bias), eval-mode BatchNorm, PReLU; no
max-pool. Four stages at widths 64, 128, 256, 512, the first block of each
with stride 2. A block: BatchNorm -> conv3x3 -> BatchNorm -> PReLU ->
conv3x3 (strided) -> BatchNorm, added to the identity or, where the shape
changes, to a strided 1 x 1 conv (no bias) and BatchNorm; nothing after the
add. Head: BatchNorm over the 512 maps, the NCHW flatten (C, then H, then
W), a linear layer with bias, BatchNorm over the embedding, L2
normalisation. Every BatchNorm has eps 1e-5 and uses its running
statistics. Parameters by insightface's names.

Departures from insightface: everything is f32 (insightface runs the trunk
under autocast and only the head in f32); dropout, the identity when
served, is left out."""

from __future__ import annotations

import torch

from perfbench.reference.precision import Precision
from perfbench.reference.resnet import _bn_shapes, batch_norm

LAYERS = (3, 13, 30, 3)
WIDTHS = (64, 128, 256, 512)
EPS = 1e-5


def param_shapes(layers=LAYERS, embedding_dim: int = 512, crop: int = 112
                 ) -> dict[str, tuple]:
    """Every leaf of the model in insightface's names and order."""
    s = {"conv1.weight": (64, 3, 3, 3), **_bn_shapes("bn1", 64), "prelu.weight": (64,)}
    cin = WIDTHS[0]
    for li, (n, c) in enumerate(zip(layers, WIDTHS), start=1):
        for bi in range(n):
            p = f"layer{li}.{bi}"
            i = cin if bi == 0 else c
            s.update(_bn_shapes(f"{p}.bn1", i))
            s[f"{p}.conv1.weight"] = (c, i, 3, 3)
            s.update(_bn_shapes(f"{p}.bn2", c))
            s[f"{p}.prelu.weight"] = (c,)
            s[f"{p}.conv2.weight"] = (c, c, 3, 3)
            s.update(_bn_shapes(f"{p}.bn3", c))
            if bi == 0:  # every stage's first block has stride 2
                s[f"{p}.downsample.0.weight"] = (c, i, 1, 1)
                s.update(_bn_shapes(f"{p}.downsample.1", c))
        cin = c
    s.update(_bn_shapes("bn2", cin))
    s["fc.weight"] = (embedding_dim, cin * (crop // 16) ** 2)
    s["fc.bias"] = (embedding_dim,)
    s.update(_bn_shapes("features", embedding_dim))
    return s


def layers_of(w: dict) -> tuple[int, ...]:
    """The block counts of a state dict."""
    return tuple(len({k.split(".")[1] for k in w if k.startswith(f"layer{i}.")})
                 for i in range(1, 5))


def prelu(x: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    """x where x > 0, else slope * x, one slope a channel (dim 1)."""
    return torch.where(x > 0, x, slope.float().view(1, -1, 1, 1) * x)


def _block(p, w, x, prefix, stride):
    y = batch_norm(x, w, f"{prefix}.bn1", EPS)
    y = batch_norm(p.conv2d(y, w[f"{prefix}.conv1.weight"], padding=1), w, f"{prefix}.bn2", EPS)
    y = prelu(y, w[f"{prefix}.prelu.weight"])
    y = p.conv2d(y, w[f"{prefix}.conv2.weight"], stride=stride, padding=1)
    y = batch_norm(y, w, f"{prefix}.bn3", EPS)
    if f"{prefix}.downsample.0.weight" in w:
        x = batch_norm(p.conv2d(x, w[f"{prefix}.downsample.0.weight"], stride=stride), w,
                       f"{prefix}.downsample.1", EPS)
    return y + x


def embed(p: Precision, w: dict, crops: torch.Tensor) -> torch.Tensor:
    """[N, S, S, 3] 0..255 -> unit [N, D] f32; the depth from ``w``."""
    x = ((crops.float() - 127.5) / 127.5).permute(0, 3, 1, 2).contiguous()
    x = batch_norm(p.conv2d(x, w["conv1.weight"], padding=1), w, "bn1", EPS)
    x = prelu(x, w["prelu.weight"])
    for li, n in enumerate(layers_of(w), start=1):
        for bi in range(n):
            x = _block(p, w, x, f"layer{li}.{bi}", 2 if bi == 0 else 1)
    x = batch_norm(x, w, "bn2", EPS)
    x = x.reshape(x.shape[0], -1)  # NCHW order: C, then H, then W
    x = batch_norm(p.linear(x, w["fc.weight"], w["fc.bias"]), w, "features", EPS)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
