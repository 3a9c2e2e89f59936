"""InceptionResnetV1 (FaceNet) at facenet-pytorch's VGGFace2 widths,
repeats (5, 10, 5), a 512-d embedding. Served only: no training."""

from __future__ import annotations

import torch

from perfbench import flops
from perfbench.reference import facenet


def shapes(emb: dict) -> dict[str, tuple]:
    return facenet.param_shapes(tuple(emb["repeats"]))


def program(state: dict, emb: dict, device, dtype=torch.bfloat16):
    """The port's served embedder (``build_facenet_embedder``) with ``state``."""
    from facerec_torch.models.facenet import build_facenet_embedder

    return build_facenet_embedder(state, dtype=dtype, device=device)


def reference(p, state: dict, crops: torch.Tensor) -> torch.Tensor:
    return facenet.embed(p, state, crops)


def macs(emb: dict) -> int:
    return flops.inception_resnet_v1_macs(emb["crop"], tuple(emb["repeats"]), emb["embedding_dim"])
