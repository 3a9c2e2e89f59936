"""Plain InceptionResnetV1 embedder (Szegedy et al. 2017; FaceNet, Schroff
et al. 2015) at facenet-pytorch's VGGFace2 widths: stem, 5 x Block35
(scale 0.17), Mixed_6a, 10 x Block17 (0.10), Mixed_7a, 5 x Block8 (0.20),
a last Block8 at scale 1.0 without ReLU, spatial mean, a 1792 -> 512
linear projection without bias, BatchNorm (eps 1e-3), L2 normalisation.
Every convolution of a branch is conv (no bias), eval-mode BatchNorm (eps
1e-3), ReLU. Input: 0..255 NHWC crops, standardised as (x - 127.5) / 128.
Parameters by facenet-pytorch's names."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.precision import Precision
from perfbench.reference.resnet import _bn_shapes, batch_norm

REPEATS = (5, 10, 5)

# (name, cin, cout, kernel, stride, padding) of every BasicConv2d, in order
STEM = [("conv2d_1a", 3, 32, (3, 3), 2, (0, 0)), ("conv2d_2a", 32, 32, (3, 3), 1, (0, 0)),
        ("conv2d_2b", 32, 64, (3, 3), 1, (1, 1)), ("conv2d_3b", 64, 80, (1, 1), 1, (0, 0)),
        ("conv2d_4a", 80, 192, (3, 3), 1, (0, 0)), ("conv2d_4b", 192, 256, (3, 3), 2, (0, 0))]
BLOCK35 = [("branch0", 256, 32, (1, 1), 1, (0, 0)), ("branch1.0", 256, 32, (1, 1), 1, (0, 0)),
           ("branch1.1", 32, 32, (3, 3), 1, (1, 1)), ("branch2.0", 256, 32, (1, 1), 1, (0, 0)),
           ("branch2.1", 32, 32, (3, 3), 1, (1, 1)), ("branch2.2", 32, 32, (3, 3), 1, (1, 1))]
BLOCK17 = [("branch0", 896, 128, (1, 1), 1, (0, 0)), ("branch1.0", 896, 128, (1, 1), 1, (0, 0)),
           ("branch1.1", 128, 128, (1, 7), 1, (0, 3)), ("branch1.2", 128, 128, (7, 1), 1, (3, 0))]
BLOCK8 = [("branch0", 1792, 192, (1, 1), 1, (0, 0)), ("branch1.0", 1792, 192, (1, 1), 1, (0, 0)),
          ("branch1.1", 192, 192, (1, 3), 1, (0, 1)), ("branch1.2", 192, 192, (3, 1), 1, (1, 0))]
MIXED6A = [("branch0", 256, 384, (3, 3), 2, (0, 0)), ("branch1.0", 256, 192, (1, 1), 1, (0, 0)),
           ("branch1.1", 192, 192, (3, 3), 1, (1, 1)), ("branch1.2", 192, 256, (3, 3), 2, (0, 0))]
MIXED7A = [("branch0.0", 896, 256, (1, 1), 1, (0, 0)), ("branch0.1", 256, 384, (3, 3), 2, (0, 0)),
           ("branch1.0", 896, 256, (1, 1), 1, (0, 0)), ("branch1.1", 256, 256, (3, 3), 2, (0, 0)),
           ("branch2.0", 896, 256, (1, 1), 1, (0, 0)), ("branch2.1", 256, 256, (3, 3), 1, (1, 1)),
           ("branch2.2", 256, 256, (3, 3), 2, (0, 0))]
# (module, its convs, the residual projection cin -> cout) of the repeated blocks
BLOCKS = {"repeat_1": (BLOCK35, 96, 256), "repeat_2": (BLOCK17, 256, 896),
          "repeat_3": (BLOCK8, 384, 1792)}


def _conv_shapes(prefix, convs):
    s = {}
    for name, cin, cout, k, _, _ in convs:
        s[f"{prefix}.{name}.conv.weight"] = (cout, cin, *k)
        s.update(_bn_shapes(f"{prefix}.{name}.bn", cout))
    return s


def param_shapes(repeats=REPEATS) -> dict[str, tuple]:
    s = {}
    for name, cin, cout, k, _, _ in STEM:
        s[f"{name}.conv.weight"] = (cout, cin, *k)
        s.update(_bn_shapes(f"{name}.bn", cout))
    for (mod, (convs, cin, cout)), n in zip(BLOCKS.items(), repeats):
        for i in range(n):
            s.update(_conv_shapes(f"{mod}.{i}", convs))
            s[f"{mod}.{i}.conv2d.weight"] = (cout, cin, 1, 1)
            s[f"{mod}.{i}.conv2d.bias"] = (cout,)
    s.update(_conv_shapes("mixed_6a", MIXED6A))
    s.update(_conv_shapes("mixed_7a", MIXED7A))
    s.update(_conv_shapes("block8", BLOCK8))
    s["block8.conv2d.weight"] = (1792, 384, 1, 1)
    s["block8.conv2d.bias"] = (1792,)
    s["last_linear.weight"] = (512, 1792)
    s.update(_bn_shapes("last_bn", 512))
    return s


def _basic(p, w, x, prefix, spec):
    _, _, _, _, stride, pad = spec
    y = p.conv2d(x, w[f"{prefix}.conv.weight"], stride=stride, padding=pad)
    return F.relu(batch_norm(y, w, f"{prefix}.bn", 1e-3))


def _convs(p, w, x, prefix, convs, names):
    for spec in convs:
        if spec[0] in names:
            x = _basic(p, w, x, f"{prefix}.{spec[0]}", spec)
    return x


def _branches(p, w, x, prefix, convs):
    """The branches of one block, each a chain of its convs in order."""
    heads = sorted({spec[0].split(".")[0] for spec in convs})
    return [_convs(p, w, x, prefix, convs, {s[0] for s in convs if s[0].split(".")[0] == h})
            for h in heads]


def _residual(p, w, x, prefix, convs, scale, relu=True):
    out = torch.cat(_branches(p, w, x, prefix, convs), dim=1)
    out = x + scale * p.conv2d(out, w[f"{prefix}.conv2d.weight"], w[f"{prefix}.conv2d.bias"])
    return F.relu(out) if relu else out


def embed(p: Precision, w: dict, crops: torch.Tensor, repeats=REPEATS) -> torch.Tensor:
    """[N, S, S, 3] 0..255 -> unit [N, 512] f32."""
    x = ((crops.float() - 127.5) / 128.0).permute(0, 3, 1, 2)
    for spec in STEM[:3]:
        x = _basic(p, w, x, spec[0], spec)
    x = F.max_pool2d(x, 3, 2)
    for spec in STEM[3:]:
        x = _basic(p, w, x, spec[0], spec)
    for i in range(repeats[0]):
        x = _residual(p, w, x, f"repeat_1.{i}", BLOCK35, 0.17)
    x = torch.cat([*_branches(p, w, x, "mixed_6a", MIXED6A), F.max_pool2d(x, 3, 2)], dim=1)
    for i in range(repeats[1]):
        x = _residual(p, w, x, f"repeat_2.{i}", BLOCK17, 0.10)
    x = torch.cat([*_branches(p, w, x, "mixed_7a", MIXED7A), F.max_pool2d(x, 3, 2)], dim=1)
    for i in range(repeats[2]):
        x = _residual(p, w, x, f"repeat_3.{i}", BLOCK8, 0.20)
    x = _residual(p, w, x, "block8", BLOCK8, 1.0, relu=False)
    x = batch_norm(p.linear(x.mean(dim=(2, 3)), w["last_linear.weight"]), w, "last_bn", 1e-3)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
