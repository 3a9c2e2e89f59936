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

Metrics come back as 0-d tensors on the batch's device; the engine reads
them once per epoch. ``compute_dtype`` "bfloat16" runs the model under
autocast with f32 parameters; the margin logits and the loss stay f32.
The train step's parts are named ranges (``train_step.forward``,
``.backward``, ``.grads``, ``.optimizer``) that torch.profiler reports.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.profiler import record_function

from facerec_torch.models import get_criterion
from facerec_torch.train.state import TrainState, global_norm


def _autocast(device: torch.device, compute_dtype: str):
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=compute_dtype == "bfloat16")


def _forward(model, model_type: str, batch: dict, epoch: float,
             generator: torch.Generator | None = None):
    """The model's outputs in its current mode: an arcface model takes the
    labels (margin logits in training, cosine logits in eval)."""
    if model_type == "arcface":
        return model(batch["image"], labels=batch["label"], epoch=epoch, generator=generator)
    return model(batch["image"], generator=generator)


def _batch_metrics(outputs: torch.Tensor, batch: dict) -> dict[str, torch.Tensor]:
    """Correct count and count (valid examples only)."""
    correct = (outputs.argmax(-1) == batch["label"].long()).float()
    mask = batch.get("mask")
    if mask is None:
        return {"correct": correct.sum(),
                "count": torch.full((), float(correct.numel()), device=correct.device)}
    m = mask.float()
    return {"correct": (correct * m).sum(), "count": m.sum()}


def make_train_step(model_type: str, compute_dtype: str = "float32") -> Callable:
    loss_fn = get_criterion(model_type)

    def train_step(state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        model = state.model
        if not model.training:
            model.train()
        dev = batch["image"].device
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
            metrics = _batch_metrics(outputs.detach(), batch)
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
        dev = batch["image"].device
        with _autocast(dev, compute_dtype):
            outputs = _forward(state.model, model_type, batch, state.epoch)
        loss = loss_fn(outputs, batch, batch.get("mask"))
        metrics = _batch_metrics(outputs, batch)
        metrics["loss_sum"] = loss * metrics["count"]
        if return_outputs:
            metrics["probs"] = torch.softmax(outputs.float(), dim=-1)
        return metrics

    return eval_step
