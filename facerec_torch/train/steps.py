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
The train step's parts are device spans of the tracing registry
(``utils.profiling``: ``train_step.forward``, ``.backward``, ``.grads``,
``.optimizer``), which the card stamps in a replay too, and ranges that
torch.profiler reports; a call is a ``train.step`` request whose host part
is ``train.step.launch``.

On a card, the train step runs as one captured program, the counterpart
of JAX's jitted step (with a mesh of several ranks, where every group is
NCCL's: ``parallel.mesh.capturable``):
``make_train_step`` returns a ``TrainStep`` that replays a
``torch.cuda.CUDAGraph`` of the eager body. The graph is captured at the
first call for each batch shape and dtype, after two eager warm-up runs on
a side stream from a snapshot of the state, which is then put back, so the
first call's step is a replay too; a capture that fails raises. Each call
copies the batch into the graph's static input, reseeds the state's
dropout generator (registered with the graph) from (seed, step), replays,
and copies the metrics out, all in stream order. The graph reads and
writes the parameters, BatchNorm statistics, optimizer moments, step
count, hyperparameters and epoch in place; a new state, model or
optimizer object, or parameters moved to new storage, captures anew.
``TrainStep.eager`` runs the body itself, as the CPU and a gloo mesh do
(gloo's collectives are host calls, which a graph cannot record). Over an
NCCL mesh the graph holds the step's collectives: the loss's global count,
the sync BatchNorm's sums forward and backward (autograd runs the backward
ones on its own thread, which the capture's ``thread_local`` mode admits),
and the gradient and metric sums. Every rank warms its groups
(``warm_collectives``) and the body before it captures, at its first call
for a batch shape, and all ranks call the step together, so they capture,
and then replay, together.

With a mesh of more than one data rank the batch is this rank's slice of
the global batch, and the steps compute what one process computes on the
global batch (as GSPMD does for the JAX steps): BatchNorm and dropout see
the global batch (``parallel.mesh.data_parallel``), the loss is the masked
mean over the global batch (the sum of the local sums over the global
count), the gradients are summed over the data ranks before the scrub, the
norm and the clip, and the metric sums are summed too, so every rank reads
the same metrics.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from facerec_torch.models import get_criterion
from facerec_torch.models.losses import pairwise_distance
from facerec_torch.parallel.collectives import psum
from facerec_torch.parallel.mesh import Mesh, capturable, data_parallel, warm_collectives
from facerec_torch.train.state import TrainState, global_norm
from facerec_torch.utils import profiling

SIAMESE_THRESHOLD = 0.5  # distance below which a pair counts as the same person


def _autocast(device: torch.device, compute_dtype: str):
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=compute_dtype == "bfloat16")


def _forward(model, model_type: str, batch: dict, epoch: torch.Tensor | float,
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


def _data_mesh(mesh: Mesh | None) -> Mesh | None:
    """``mesh`` when its data axis has more than one rank."""
    return mesh if mesh is not None and mesh.size(mesh.data_axis) > 1 else None


def _psum_metrics(metrics: dict[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """Every metric sum summed over the data ranks, in one collective."""
    keys = list(metrics)
    total = psum(torch.stack([metrics[k].float() for k in keys]), mesh, mesh.data_axis)
    return dict(zip(keys, total.unbind()))


def _psum_grads(grads: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """The gradients summed over the data ranks, in one collective."""
    flat = psum(torch.cat([g.reshape(-1) for g in grads]), mesh, mesh.data_axis)
    return [part.view(g.shape) for g, part in zip(grads, flat.split([g.numel() for g in grads]))]


WARMUP_RUNS = 2  # eager runs of the step on a side stream before its capture


class _Captured(NamedTuple):
    """One captured step: its graph, static batch and static metrics."""
    graph: torch.cuda.CUDAGraph
    batch: dict[str, torch.Tensor]
    metrics: dict[str, torch.Tensor]


class TrainStep:
    """``step(state, batch) -> metrics``: one train step that advances
    ``state`` in place; on a card, a replay of its CUDA graph where the
    mesh is ``capturable`` (module docstring)."""

    def __init__(self, model_type: str, compute_dtype: str = "float32",
                 mesh: Mesh | None = None):
        self.model_type = model_type
        self.compute_dtype = compute_dtype
        self._loss_fn = get_criterion(model_type)
        self._sharded = _data_mesh(mesh)
        self._mesh = mesh
        self._capturable = capturable(mesh)
        self._graphs: dict[tuple, _Captured] = {}
        self._graph_inputs: tuple | None = None  # what the graphs read in place
        self._pool = None  # the graphs' shared memory pool

    def __call__(self, state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        with profiling.request("train.step", state.device), profiling.span("train.step.launch"):
            return self._call(state, batch)

    def _call(self, state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        if state.device.type != "cuda" or not self._capturable:
            return self.eager(state, batch)
        model = state.model
        inputs = (state, model, state.opt_state,
                  *(t.data_ptr() for t in (*model.parameters(), *model.buffers())))
        if inputs != self._graph_inputs:
            self._graphs.clear()  # a graph reads these in place: a new one captures anew
            self._graph_inputs = inputs
            # a pool is shared only while a graph holds it: the new graphs take a new one
            self._pool = None
        key = (tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in batch.items())),
               profiling.enabled())
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._graphs[key] = self._capture(state, batch)
        if not model.training:  # as the body would: a replay runs no Python
            model.train()
        for k, v in batch.items():
            cap.batch[k].copy_(v)
        state.dropout_generator()
        cap.graph.replay()
        state.step += 1
        return {k: v.clone() for k, v in cap.metrics.items()}

    def eager(self, state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        """The step as a sequence of launches (no graph)."""
        metrics = self._body(state, batch, state.dropout_generator())
        state.step += 1
        return metrics

    def _capture(self, state: TrainState, batch: dict) -> _Captured:
        """Warm the body up on a side stream from a snapshot of ``state``,
        put the snapshot back, then capture the body on a static copy of
        ``batch`` into the step's pool, with the state's generator
        registered. Raises if the capture fails."""
        dev = state.device
        warm_collectives(self._mesh)
        with torch.cuda.device(dev):
            static = {k: v.clone() for k, v in batch.items()}
            live = _state_tensors(state)
            with torch.no_grad():
                saved = [t.clone() for t in live]
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    self._body(state, static, state.dropout_generator())
            torch.cuda.current_stream(dev).wait_stream(side)
            with torch.no_grad():
                torch._foreach_copy_(live, saved)
            del saved
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(state.generator)
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                metrics = self._body(state, static, state.generator)
        return _Captured(graph, static, metrics)

    def _body(self, state: TrainState, batch: dict,
              generator: torch.Generator) -> dict[str, torch.Tensor]:
        """The eager step: forward, loss, gradients, metrics, optimizer."""
        model_type, sharded = self.model_type, self._sharded
        model = state.model
        if not model.training:
            model.train()
        dev = state.device
        params = state.opt_state.params
        with profiling.device_span("train_step.forward", dev):
            with _autocast(dev, self.compute_dtype), data_parallel(sharded):
                outputs = _forward(model, model_type, batch, state.epoch_tensor, generator)
            loss = self._loss_fn(outputs, batch, batch.get("mask"))
            objective = loss
            if sharded is not None:  # this rank's share of the global masked mean
                local = _count(outputs, batch)
                objective = loss * local / torch.clamp(psum(local, sharded), min=1.0)
        with profiling.device_span("train_step.backward", dev):
            grads = torch.autograd.grad(objective, params, allow_unused=True)
        with profiling.device_span("train_step.grads", dev), torch.no_grad():
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
            if sharded is not None:
                grads = _psum_grads(grads, sharded)
            grads = [torch.nan_to_num_(g, 0.0, 0.0, 0.0) for g in grads]
            metrics = _batch_metrics(model_type, outputs, batch)
            metrics["loss_sum"] = loss.detach() * metrics["count"]
            if sharded is not None:
                metrics = _psum_metrics(metrics, sharded)
            metrics["grad_norm"] = global_norm(grads)
        with profiling.device_span("train_step.optimizer", dev):
            state.opt_state.step(grads)
        return metrics


def _state_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor a step writes: parameters, buffers, optimizer moments
    and the step count."""
    opt = state.opt_state
    return [*state.model.state_dict().values(), *(t for ts in opt.slots.values() for t in ts),
            opt.count_tensor]


def make_train_step(model_type: str, compute_dtype: str = "float32",
                    mesh: Mesh | None = None) -> TrainStep:
    return TrainStep(model_type, compute_dtype, mesh)


def _count(outputs, batch: dict) -> torch.Tensor:
    """The valid examples of this rank's slice (f32)."""
    mask = batch.get("mask")
    if mask is not None:
        return mask.float().sum()
    first = outputs[0] if isinstance(outputs, tuple) else outputs
    # a fill, not a copy from the host: a capture admits no such copy
    return torch.full((), float(first.shape[0]), device=first.device)


def make_eval_step(model_type: str, compute_dtype: str = "float32",
                   return_outputs: bool = False, mesh: Mesh | None = None) -> Callable:
    """The eval step; with a mesh the metric sums are summed over the data
    ranks, and the outputs (``return_outputs``) stay this rank's rows."""
    loss_fn = get_criterion(model_type)
    sharded = _data_mesh(mesh)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict[str, Any]:
        if state.model.training:
            state.model.eval()
        with _autocast(_device(state.model), compute_dtype):
            outputs = _forward(state.model, model_type, batch, state.epoch_tensor)
        loss = loss_fn(outputs, batch, batch.get("mask"))
        metrics = _batch_metrics(model_type, outputs, batch)
        metrics["loss_sum"] = loss * metrics["count"]
        if sharded is not None:
            metrics = _psum_metrics(metrics, sharded)
        if return_outputs:
            if model_type == "siamese":
                metrics["distances"] = pairwise_distance(*outputs)
            else:
                metrics["probs"] = torch.softmax(outputs.float(), dim=-1)
        return metrics

    return eval_step
