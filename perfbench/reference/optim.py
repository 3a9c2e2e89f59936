"""Plain optimizers of the training reference, chosen by the configuration's
``train.optimizer.name``. Each clips the gradients to the global norm
``clip_norm`` first and returns the norm before the clip from ``step``;
its ``first_gradient`` reads the first step's clipped gradient back from
the port's optimizer state (optax's slot names) after that step, a dict it
reads and never writes. A new optimizer is a class here, in ``OPTIMIZERS``.

* ``adam``: Adam (``learning_rate``, ``beta1``, ``beta2``; eps 1e-8).
* ``sgd``: SGD with momentum as optax's ``sgd`` computes it (``learning_rate``,
  ``momentum``): trace = momentum x trace + g, the update -lr x trace; no
  weight decay."""

from __future__ import annotations

import torch

# fixed in the port, not set by a configuration: Adam's eps (optax's)
ADAM_EPS = 1e-8


def _clipped(grads: list[torch.Tensor], clip_norm: float
             ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """(the gradients clipped to ``clip_norm``, their global norm before the
    clip); non-finite values count as 0."""
    grads = [torch.nan_to_num(g, 0.0, 0.0, 0.0) for g in grads]
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    unclipped = norm.clone()
    if norm >= clip_norm:
        grads = [g / norm * clip_norm for g in grads]
    return grads, unclipped


class Adam:
    """Adam with the gradients clipped to a global norm first."""

    KEYS = ("learning_rate", "beta1", "beta2", "clip_norm")

    def __init__(self, params: list[torch.Tensor], opt: dict):
        self.opt = opt
        self.mu = [torch.zeros_like(q) for q in params]
        self.nu = [torch.zeros_like(q) for q in params]
        self.t = 0

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor]) -> torch.Tensor:
        """Update ``params`` in place; returns the global norm of the
        gradients before the clip."""
        o = self.opt
        grads, unclipped = _clipped(grads, o["clip_norm"])
        self.t += 1
        b1, b2 = o["beta1"], o["beta2"]
        for q, g, m, v in zip(params, grads, self.mu, self.nu):
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            upd = (m / (1.0 - b1 ** self.t)) / (torch.sqrt(v / (1.0 - b2 ** self.t)) + ADAM_EPS)
            q.sub_(o["learning_rate"] * upd)
        return unclipped

    @staticmethod
    def first_gradient(slots: dict, opt: dict) -> list[torch.Tensor]:
        """The first moment over 1 - beta1."""
        return [m.detach().float() / (1.0 - opt["beta1"]) for m in slots["mu"]]


class SGD:
    """SGD with momentum with the gradients clipped to a global norm first."""

    KEYS = ("learning_rate", "momentum", "clip_norm")

    def __init__(self, params: list[torch.Tensor], opt: dict):
        self.opt = opt
        self.trace = [torch.zeros_like(q) for q in params]

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor]) -> torch.Tensor:
        """Update ``params`` in place; returns the global norm of the
        gradients before the clip."""
        o = self.opt
        grads, unclipped = _clipped(grads, o["clip_norm"])
        for q, g, m in zip(params, grads, self.trace):
            m.mul_(o["momentum"]).add_(g)
            q.sub_(o["learning_rate"] * m)
        return unclipped

    @staticmethod
    def first_gradient(slots: dict, opt: dict) -> list[torch.Tensor]:
        """The momentum trace, which after one step is the clipped gradient."""
        return [m.detach().float() for m in slots["trace"]]


OPTIMIZERS = {"adam": Adam, "sgd": SGD}


def check(opt: dict) -> type:
    """The optimizer class ``opt`` names; a ValueError naming what is wrong
    where the name is unknown or a key it reads is missing."""
    name = opt.get("name")
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}: the reference has {', '.join(OPTIMIZERS)}")
    cls = OPTIMIZERS[name]
    missing = [k for k in cls.KEYS if k not in opt]
    if missing:
        raise ValueError(f"optimizer {name!r} needs {', '.join(missing)}")
    return cls


def make(params: list[torch.Tensor], opt: dict):
    """The optimizer ``opt`` names, over ``params``."""
    return check(opt)(params, opt)
