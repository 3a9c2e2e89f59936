"""EnsembleModel (counterpart of ``facerec_tpu/models/ensemble.py``): one
prediction from several member models.

Methods: ``average``; ``weighted`` (softmax of the learnable ``weights``,
init 1/n); ``attention`` (``attn1`` of 64 and ``attn2`` of n over
softmax(``weights``), softmaxed); ``max`` (log of the per-class max of the
members' probabilities, plus 1e-12). ArcFace members give cosine logits
against their class centres; siamese members give no logits and are
skipped. ``embed`` concatenates every member's embedding.

The members are registered as ``members_0``, ``members_1``, ... (the JAX
tree's names) and always run in eval mode, BatchNorm on its running
statistics and no dropout, even while the ensemble trains: ``train()``
leaves them in eval mode. Their parameters still take gradients, as in the
JAX train step."""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import torch
import torch.nn as nn

METHODS = ("average", "weighted", "attention", "max")


class EnsembleModel(nn.Module):
    def __init__(self, members: Sequence[nn.Module], member_types: Sequence[str],
                 ensemble_method: str = "average"):
        super().__init__()
        if ensemble_method not in METHODS:
            raise ValueError(f"Unknown ensemble method: {ensemble_method}")
        n = len(members)
        for i, m in enumerate(members):
            self.add_module(f"members_{i}", m)
        self.member_types = list(member_types)
        self.ensemble_method = ensemble_method
        if ensemble_method in ("weighted", "attention"):
            self.weights = nn.Parameter(torch.full((n,), 1.0 / n))
        if ensemble_method == "attention":
            self.attn1 = nn.Linear(n, 64)
            self.attn2 = nn.Linear(64, n)
        self.train()

    @property
    def members(self) -> list[nn.Module]:
        return [getattr(self, f"members_{i}") for i in range(len(self.member_types))]

    def train(self, mode: bool = True) -> "EnsembleModel":
        super().train(mode)
        for m in self.members:
            m.eval()
        return self

    def _member_logits(self, x: torch.Tensor) -> list[torch.Tensor]:
        outputs = []
        for m, t in zip(self.members, self.member_types):
            if t == "siamese":  # verification only: no class logits
                continue
            if t == "arcface":
                outputs.append(m(x, labels=torch.zeros(x.shape[0], dtype=torch.long, device=x.device)))
            else:
                outputs.append(m(x))
        return outputs

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        outputs = self._member_logits(x)
        if len(outputs) == 1:
            return outputs[0]
        stacked = torch.stack([o.float() for o in outputs])  # [M, B, C]
        if self.ensemble_method == "average":
            return stacked.mean(dim=0)
        if self.ensemble_method == "weighted":
            w = torch.softmax(self.weights, dim=0)
        elif self.ensemble_method == "attention":
            w = torch.softmax(self.attn2(torch.relu(self.attn1(torch.softmax(self.weights, dim=0)))),
                              dim=0)
        else:  # max
            return torch.log(torch.softmax(stacked, dim=-1).amax(dim=0) + 1e-12)
        return torch.einsum("m,mbc->bc", w.float(), stacked)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([m.embed(x).float() for m in self.members], dim=-1)


def create_pretrained_ensemble(member_names: dict[str, str], num_classes: int,
                               checkpoints_root: str | Path | None = None,
                               ensemble_method: str = "average") -> EnsembleModel:
    """An ensemble whose members carry their own trained checkpoints (each
    member's ``best``, else ``final``, under ``checkpoints_root``):
    ``member_names`` maps model type -> model name. The combiner's own
    parameters, if any, take their initial values (``weights`` 1/n, the
    attention layers Flax's defaults from seed 0)."""
    from facerec_torch.config import CHECKPOINTS_DIR
    from facerec_torch.models import create_ensemble
    from facerec_torch.models.arcface import init_like_flax
    from facerec_torch.train.checkpoints import load_checkpoint

    root = Path(checkpoints_root or CHECKPOINTS_DIR)
    ens = create_ensemble(list(member_names), num_classes, ensemble_method)
    init_like_flax(ens, torch.Generator().manual_seed(0))
    for m, name in zip(ens.members, member_names.values()):
        m.load_state_dict(load_checkpoint(root / name)["model"])
    return ens
