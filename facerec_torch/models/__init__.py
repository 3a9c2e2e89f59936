"""Model registry (counterpart of ``facerec_tpu/models/__init__.py``): the
seven model types of the JAX package, and ensembles of them."""

from __future__ import annotations

from typing import Any, Sequence

import torch

from facerec_torch.models.arcface import ArcFaceNet
from facerec_torch.models.attention import AttentionModule, AttentionNet, SpatialAttention
from facerec_torch.models.baseline import BaselineNet
from facerec_torch.models.ensemble import EnsembleModel
from facerec_torch.models.hybrid import HybridNet, TransformerBlock
from facerec_torch.models.losses import LOSS_CONFIG, contrastive_loss, cross_entropy, pairwise_distance
from facerec_torch.models.resnet import ResNet18
from facerec_torch.models.siamese import SiameseNet
from facerec_torch.models.transfer import ResNetTransfer

MODEL_TYPES = ["baseline", "cnn", "siamese", "attention", "arcface", "hybrid", "ensemble"]

DEFAULT_ENSEMBLE_MEMBERS = ["cnn", "attention", "arcface"]


def get_model(
    model_type: str | Sequence[str],
    num_classes: int = 18,
    param_dtype: str = "float32",
    dropout_rate: float | None = None,
    arcface_kwargs: dict[str, Any] | None = None,
    ensemble_method: str = "average",
) -> torch.nn.Module:
    """Model factory. The parameters are ``param_dtype``; the compute dtype
    is the train and eval steps' (autocast), not the module's. A
    ``dropout_rate`` of None or 0 takes the model's default, as in the JAX
    factory; a list of types builds an ensemble of them."""
    if isinstance(model_type, (list, tuple)):
        return create_ensemble(list(model_type), num_classes, ensemble_method, param_dtype)
    if model_type == "baseline":
        model = BaselineNet(num_classes=num_classes, dropout_rate=dropout_rate or 0.5)
    elif model_type == "cnn":
        model = ResNetTransfer(num_classes=num_classes, dropout_rate=dropout_rate or 0.1)
    elif model_type == "siamese":
        model = SiameseNet()
    elif model_type == "attention":
        model = AttentionNet(num_classes=num_classes, dropout_rate=dropout_rate or 0.25)
    elif model_type == "arcface":
        model = ArcFaceNet(num_classes=num_classes, dropout_rate=dropout_rate or 0.2,
                           **dict(arcface_kwargs or {}))
    elif model_type == "hybrid":
        model = HybridNet(num_classes=num_classes)
    elif model_type == "ensemble":
        return create_ensemble(DEFAULT_ENSEMBLE_MEMBERS, num_classes, ensemble_method, param_dtype)
    else:
        raise ValueError(f"Invalid model type: {model_type}")
    return model.to(getattr(torch, param_dtype))


def create_ensemble(model_types: list[str], num_classes: int, ensemble_method: str = "average",
                    param_dtype: str = "float32") -> EnsembleModel:
    """An ensemble of freshly built members of ``model_types``, each with
    its factory defaults."""
    members = [get_model(t, num_classes=num_classes, param_dtype=param_dtype) for t in model_types]
    return EnsembleModel(members, model_types, ensemble_method).to(getattr(torch, param_dtype))


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


__all__ = [
    "MODEL_TYPES", "DEFAULT_ENSEMBLE_MEMBERS", "get_model", "get_criterion", "create_ensemble",
    "BaselineNet", "ResNetTransfer", "SiameseNet", "AttentionNet", "AttentionModule",
    "SpatialAttention", "ArcFaceNet", "HybridNet", "TransformerBlock", "EnsembleModel",
    "ResNet18", "cross_entropy", "contrastive_loss", "pairwise_distance",
]
