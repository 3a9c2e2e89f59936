"""One module an embedder kind (the configuration's ``embedder.kind``):
``embedders/<kind>.py``, found by that name (``get``).

For serving a kind's module provides (``emb``: the configuration's
``embedder`` section):

* ``shapes(emb)``: the served model's leaves {name: shape}, in the
  program's state-dict order;
* ``program(state, emb, device, dtype)``: the port's served embedder on
  ``state``, with ``embed(crops)``;
* ``reference(p, state, crops)``: the plain reference's forward pass, unit
  embeddings from 0..255 crops;
* ``macs(emb)``: the forward multiply-adds of one crop: the benchmark's own
  count, made in the kind's module from ``flops``'s helpers (``conv_macs``,
  ``conv_out``) or a counting function ``flops`` already has; a new kind
  does not edit ``flops.py``.

A kind that trains also provides (``t``: the configuration's ``train``
section):

* ``train_shapes(t)``: the trained model's leaves {name: shape} and
  ``train_param_names(t)``, its trainable leaves, both in the program's
  state-dict order;
* ``train_program(t, optimizer, batch, seed, device, mesh)``: the port's
  (train state, train step), the state's model built and initialised,
  ``optimizer`` the port's ``OptimizerConfig``, ``seed`` its dropout seed;
* ``train_loss(p, w, images, labels, keep, t, mask=None, stats=None)``: the
  reference's mean loss of a batch, each BatchNorm's batch statistics put
  in ``stats``, and ``update_running(running, stats)``, the running
  statistics' update from them; ``keep`` is one example's dropout mask over
  the embedding, as ArcFace's head (``train_arcface.margin_loss``) takes it;
* ``train_macs(t, image)``: the forward multiply-adds of one training image,
  counted as ``macs`` is.

The optimizer is the configuration's ``train.optimizer``, by name, in
``reference/optim.py``, not the kind's.

A new architecture enters the benchmark as new files alone:
``embedders/<kind>.py`` and the reference it points at,
``reference/<arch>.py``; ``configs/<config>.json``; ``limits/<cell>.json``,
with ``traffic/<mix>.json`` where the mix is new; ``metrics/<name>.py`` for
a new metric; and its entries in ``BENCHMARK.json``, the cell's name
appended to the ``workloads`` list of each metric it reports."""

from __future__ import annotations

import importlib

SERVE = ("shapes", "program", "reference", "macs")
TRAIN = ("train_shapes", "train_param_names", "train_program", "train_loss", "update_running",
         "train_macs")


def get(kind: str, train: bool = False):
    """The module of ``kind``, with what serving (with ``train``: training)
    needs of it; a ValueError naming the kind where there is none or it
    lacks a part."""
    name = f"perfbench.embedders.{kind}"
    try:
        mod = importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no embedder kind {kind!r}: perfbench/embedders/{kind}.py is missing"
                         ) from None
    missing = [f for f in (TRAIN if train else SERVE) if not hasattr(mod, f)]
    if missing:
        what = "does not train" if train else "cannot serve"
        raise ValueError(f"embedder kind {kind!r} {what}: perfbench/embedders/{kind}.py has no "
                         f"{', '.join(missing)}")
    return mod
