"""Train and eval steps (counterpart of ``facerec_tpu/train/steps.py``).

``train_step`` puts the model in training mode (``model.train()``: batch
statistics, the running ones updated as Flax does, dropout from a generator
seeded from the state's seed and step) and runs the forward pass, the loss,
the gradients, and the optimizer (``eval_step`` puts the model in eval
mode). In the train step:

  * non-finite gradients are scrubbed to 0 before the update;
  * ``grad_norm`` is the global norm of the scrubbed gradients, before the
    backbone scale and the clip;
  * ``loss_sum = loss * count``, so that an epoch's loss is a mean over its
    valid examples.

Metrics come back as 0-d tensors on the model's device; the engine reads
them once per epoch. A siamese batch is a pair batch (``image_a``,
``image_b``, ``pair_label``), and its metrics also count the same and the
different pairs apart. ``compute_dtype`` "bfloat16" runs the model under
autocast with f32 parameters; the margin logits and the loss stay f32.
The train step's parts are named ranges (``train_step.forward``,
``.backward``, ``.grads``, ``.optimizer``) that torch.profiler reports.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.profiler import record_function

from facerec_torch.models import get_criterion
from facerec_torch.models.losses import pairwise_distance
from facerec_torch.train.state import TrainState, global_norm

SIAMESE_THRESHOLD = 0.5  # distance below which a pair counts as the same person


def _autocast(device: torch.device, compute_dtype: str):
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=compute_dtype == "bfloat16")


def _forward(model, model_type: str, batch: dict, epoch: float,
             generator: torch.Generator | None = None):
    """The model's outputs in its current mode: an arcface model takes the
    labels (margin logits in training, cosine logits in eval); a siamese
    model takes both images of each pair and gives both embeddings."""
    if model_type == "siamese":
        return model(batch["image_a"], batch["image_b"], generator=generator)
    if model_type == "arcface":
        return model(batch["image"], labels=batch["label"], epoch=epoch, generator=generator)
    return model(batch["image"], generator=generator)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _batch_metrics(model_type: str, outputs, batch: dict,
                   threshold: float = SIAMESE_THRESHOLD) -> dict[str, torch.Tensor]:
    """Correct count and count (valid examples only); for siamese, a pair
    is predicted same when its distance is below ``threshold``, and the
    same and different pairs are also counted apart."""
    mask = batch.get("mask")
    if model_type == "siamese":
        ea, eb = outputs
        correct = ((pairwise_distance(ea, eb) < threshold).long()
                   == batch["pair_label"].long()).float()
        same = batch["pair_label"].float()
    else:
        correct = (outputs.argmax(-1) == batch["label"].long()).float()
    m = torch.ones_like(correct) if mask is None else mask.float()
    out = {"correct": (correct * m).sum(), "count": m.sum()}
    if model_type == "siamese":
        out |= {"same_correct": (correct * same * m).sum(), "same_count": (same * m).sum(),
                "diff_correct": (correct * (1 - same) * m).sum(),
                "diff_count": ((1 - same) * m).sum()}
    return out


def make_train_step(model_type: str, compute_dtype: str = "float32") -> Callable:
    loss_fn = get_criterion(model_type)

    def train_step(state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        model = state.model
        if not model.training:
            model.train()
        dev = _device(model)
        params = state.opt_state.params
        with record_function("train_step.forward"):
            with _autocast(dev, compute_dtype):
                outputs = _forward(model, model_type, batch, state.epoch,
                                   state.dropout_generator(dev))
            loss = loss_fn(outputs, batch, batch.get("mask"))
        with record_function("train_step.backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        with record_function("train_step.grads"), torch.no_grad():
            grads = [torch.zeros_like(p) if g is None else torch.nan_to_num_(g, 0.0, 0.0, 0.0)
                     for g, p in zip(grads, params)]
            metrics = _batch_metrics(model_type, outputs, batch)
            metrics["grad_norm"] = global_norm(grads)
            metrics["loss_sum"] = loss.detach() * metrics["count"]
        with record_function("train_step.optimizer"):
            state.opt_state.step(grads)
        state.step += 1
        return metrics

    return train_step


def make_eval_step(model_type: str, compute_dtype: str = "float32",
                   return_outputs: bool = False) -> Callable:
    loss_fn = get_criterion(model_type)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict[str, Any]:
        if state.model.training:
            state.model.eval()
        with _autocast(_device(state.model), compute_dtype):
            outputs = _forward(state.model, model_type, batch, state.epoch)
        loss = loss_fn(outputs, batch, batch.get("mask"))
        metrics = _batch_metrics(model_type, outputs, batch)
        metrics["loss_sum"] = loss * metrics["count"]
        if return_outputs:
            if model_type == "siamese":
                metrics["distances"] = pairwise_distance(*outputs)
            else:
                metrics["probs"] = torch.softmax(outputs.float(), dim=-1)
        return metrics

    return eval_step
