"""Serve-time BatchNorm folding (counterpart of ``facerec_tpu/models/fold.py``).

In eval mode a BatchNorm after a bias-free convolution or dense layer is a
per-channel affine, ``y = (x - mean) * gamma / sqrt(var + eps) + beta``,
which folds into the producer's weight once:

    W' = W * s     (s = gamma / sqrt(var + eps), over the output channels,
                    dim 0 of both a conv [O, I, kh, kw] and a dense [out, in]
                    weight)
    b' = beta - mean * s

computed in f32 and cast back to each tensor's dtype; the BatchNorm becomes
a ``FoldedBias`` holding b'. Each BatchNorm is paired with its producer by
the JAX package's naming table, in the port's names (``bn1`` -> ``conv1``,
``downsample.1`` -> ``downsample.0``, ``bn`` -> ``embedding``/``dense``/
``fc1``/``conv``, ``last_bn`` -> ``last_linear``), and folds with its own
eps (1e-5 in the ResNet zoo, 1e-3 in InceptionResnetV1). A BatchNorm with no
producer, one without running statistics, or a producer with a bias of its
own raises: nothing is skipped quietly.

Serving stays unfolded, as in the JAX package; ``chip_smoke.py`` times the
folded embed stage against the unfolded one.
"""

from __future__ import annotations

import copy
import types
from typing import Mapping

import torch
import torch.nn as nn

from facerec_torch import resolve_device

# BatchNorm name (the last one or two parts of its qualified name) ->
# candidate producers beside it, first hit wins
_BN_PRODUCERS: dict[str, tuple[str, ...]] = {
    "bn1": ("conv1",),
    "bn2": ("conv2",),
    "bn3": ("conv3",),
    "downsample.1": ("downsample.0",),
    "bn": ("embedding", "dense", "fc1", "conv"),
    "last_bn": ("last_linear",),
}
_EVAL_ONLY = "folded models are eval-only (the BatchNorm statistics are baked in)"


def _eval_only_train(self: nn.Module, mode: bool = True) -> nn.Module:
    if mode:
        raise ValueError(_EVAL_ONLY)
    return nn.Module.train(self, False)


class FoldedBias(nn.Module):
    """Stand-in for an eval BatchNorm folded into its producer: a
    per-channel bias-add over dim 1, its parameter named ``bias`` as the
    BatchNorm's was."""

    def __init__(self, bias: torch.Tensor):
        super().__init__()
        self.bias = nn.Parameter(bias, requires_grad=False)
        self.training = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.bias.reshape(-1, *([1] * (x.dim() - 2)))

    train = _eval_only_train


def _producer(modules: dict[str, nn.Module], name: str) -> str:
    for key, candidates in _BN_PRODUCERS.items():
        if name == key or name.endswith("." + key):
            prefix = name[:len(name) - len(key)]
            for c in candidates:
                if isinstance(modules.get(prefix + c), (nn.Conv2d, nn.Linear)):
                    return prefix + c
    siblings = sorted(n.rpartition(".")[2] for n in modules
                      if n.rpartition(".")[0] == name.rpartition(".")[0])
    raise ValueError(f"BatchNorm {name} has no foldable producer (siblings: {siblings})")


@torch.no_grad()
def fold_batchnorm(module: nn.Module) -> nn.Module:
    """An eval-only copy of ``module`` with every BatchNorm folded into its
    producer; ``train()`` on it raises."""
    folded = copy.deepcopy(module).eval()
    modules = dict(folded.named_modules())
    for name, bn in modules.items():
        if not isinstance(bn, nn.modules.batchnorm._BatchNorm):
            continue
        if bn.running_mean is None or bn.running_var is None:
            raise ValueError(f"BatchNorm {name} has no running statistics (mean/var): cannot fold")
        prod = modules[_producer(modules, name)]
        if prod.bias is not None:
            raise ValueError(f"{name}'s producer carries a bias before its BatchNorm")
        gamma = bn.weight.float() if bn.weight is not None else 1.0
        beta = bn.bias.float() if bn.bias is not None else 0.0
        s = gamma / torch.sqrt(bn.running_var.float() + bn.eps)
        w = prod.weight
        w.copy_((w.float() * s.reshape(-1, *([1] * (w.dim() - 1)))).to(w.dtype))
        bias = (beta - bn.running_mean.float() * s).to(bn.running_mean.dtype)
        parent, _, attr = name.rpartition(".")
        setattr(modules[parent], attr, FoldedBias(bias))
    folded.train = types.MethodType(_eval_only_train, folded)
    return folded


def folded_arcface(state: Mapping[str, torch.Tensor], dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device | None = None) -> nn.Module:
    """The serve-side fold in one call: the ArcFace embedder of a port
    state dict (its shapes from the weights), folded in f32, in ``dtype`` on
    ``device`` (default: the CUDA card)."""
    from facerec_torch.models.arcface import ArcFaceNet

    dev = resolve_device(device)
    embedding_dim, in_dim = state["embedding.weight"].shape
    model = ArcFaceNet(embedding_dim, in_dim // 8, num_classes=state["arc_weight"].shape[0])
    model.load_state_dict(state)
    return fold_batchnorm(model.float()).to(device=dev, dtype=dtype)


def folded_facenet(state: Mapping[str, torch.Tensor], dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device | None = None) -> nn.Module:
    """A facenet-pytorch InceptionResnetV1 state dict as a folded embedder
    whose ``embed`` takes 0..255 crops, as ``build_facenet_embedder``'s."""
    from facerec_torch.models.facenet import build_facenet_embedder

    dev = resolve_device(device)
    model = build_facenet_embedder(state, dtype=torch.float32, device="cpu")
    return fold_batchnorm(model).to(device=dev, dtype=dtype)
