"""ResNet-18 ArcFace (He et al. 2016; Deng et al. 2019) at 64-128-256-512,
a 512-d embedding; trained as the port's ``arcface`` model type, whose
reference is ``reference/train_arcface.py``."""

from __future__ import annotations

import torch

from perfbench import flops
from perfbench.reference import resnet, train_arcface

MODEL_TYPE = "arcface"  # the port's model type: its factory, loss and step


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


def macs(emb: dict) -> int:
    return flops.resnet18_macs(emb["crop"], emb["width"], embedding_dim=emb["embedding_dim"])


def train_shapes(t: dict) -> dict[str, tuple]:
    return train_arcface.param_shapes(t["embedding_dim"], t["num_classes"])


def train_param_names(t: dict) -> list[str]:
    return train_arcface.param_names(t["embedding_dim"], t["num_classes"])


def train_program(t: dict, optimizer, batch: int, seed: int, device, mesh=None):
    """The port's ArcFace model (``get_model``), its train state and its
    train step."""
    from facerec_torch.config import TrainConfig
    from facerec_torch.models import get_model
    from facerec_torch.train.state import create_train_state
    from facerec_torch.train.steps import make_train_step

    model = get_model(MODEL_TYPE, num_classes=t["num_classes"], dropout_rate=t["dropout"],
                      arcface_kwargs={"margin": t["margin"], "scale": t["scale"],
                                      "warmup_epochs": t["warmup_epochs"]})
    cfg = TrainConfig(model_type=MODEL_TYPE, batch_size=batch, num_classes=t["num_classes"],
                      seed=seed, compute_dtype=t["compute_dtype"], optimizer=optimizer)
    state = create_train_state(model, cfg, MODEL_TYPE, torch.device(device))
    return state, make_train_step(MODEL_TYPE, t["compute_dtype"], mesh)


train_loss = train_arcface.loss
update_running = train_arcface.update_running


def train_macs(t: dict, image: int) -> int:
    return flops.resnet18_macs(image, t["width"], embedding_dim=t["embedding_dim"])
