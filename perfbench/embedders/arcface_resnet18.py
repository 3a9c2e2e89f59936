"""ResNet-18 ArcFace (He et al. 2016; Deng et al. 2019) at 64-128-256-512,
a 512-d embedding."""

from __future__ import annotations

import torch

from perfbench.reference import resnet


def shapes(emb: dict) -> dict[str, tuple]:
    """The served model's leaves; it carries the training head's class
    centres (``param_shapes``'s default), which serving never reads."""
    return resnet.param_shapes(emb["embedding_dim"])


def program(state: dict, emb: dict, device, dtype=torch.bfloat16):
    """The port's served embedder (``build_embedder``) with ``state``."""
    from facerec_torch.models.arcface import build_embedder

    model = build_embedder(embedding_dim=emb["embedding_dim"], width=emb["width"], dtype=dtype,
                           device=device)
    model.load_state_dict(state)
    return model


def reference(p, state: dict, crops: torch.Tensor) -> torch.Tensor:
    return resnet.embed(p, state, crops)
