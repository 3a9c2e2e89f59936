"""Model registry (counterpart of ``facerec_tpu/models/__init__.py``).

The port has ``baseline`` and ``arcface``; the other five model types of
the JAX package are ROADMAP work and are refused by name.
"""

from __future__ import annotations

from typing import Any

import torch

from facerec_torch.models.arcface import ArcFaceNet
from facerec_torch.models.baseline import BaselineNet
from facerec_torch.models.losses import LOSS_CONFIG, contrastive_loss, cross_entropy
from facerec_torch.models.resnet import ResNet18

MODEL_TYPES = ["baseline", "arcface"]


def get_model(
    model_type: str,
    num_classes: int = 18,
    param_dtype: str = "float32",
    dropout_rate: float | None = None,
    arcface_kwargs: dict[str, Any] | None = None,
) -> torch.nn.Module:
    """Model factory. The parameters are ``param_dtype``; the compute dtype
    is the train and eval steps' (autocast), not the module's. A
    ``dropout_rate`` of None or 0 takes the model's default, as in the JAX
    factory."""
    if model_type == "baseline":
        model = BaselineNet(num_classes=num_classes, dropout_rate=dropout_rate or 0.5)
    elif model_type == "arcface":
        model = ArcFaceNet(num_classes=num_classes, dropout_rate=dropout_rate or 0.2,
                           **dict(arcface_kwargs or {}))
    else:
        raise NotImplementedError(
            f"model type {model_type!r} is not ported to facerec_torch yet (ROADMAP section 1); "
            f"ported: {MODEL_TYPES}")
    return model.to(getattr(torch, param_dtype))


def get_criterion(model_type: str):
    """``loss_fn(outputs, batch, mask) -> scalar`` for a model type."""
    if model_type not in LOSS_CONFIG:
        raise ValueError(f"Invalid model type: {model_type}")
    name, kwargs = LOSS_CONFIG[model_type]
    if name == "contrastive":
        def loss_fn(outputs, batch, mask=None):
            emb_a, emb_b = outputs
            return contrastive_loss(emb_a, emb_b, batch["pair_label"], mask=mask, **kwargs)
    else:
        def loss_fn(outputs, batch, mask=None):
            return cross_entropy(outputs, batch["label"], mask=mask, **kwargs)
    return loss_fn


__all__ = ["MODEL_TYPES", "get_model", "get_criterion", "ArcFaceNet", "BaselineNet", "ResNet18"]
