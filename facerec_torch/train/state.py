"""Train state and the optimizer (counterpart of ``facerec_tpu/train/state.py``).

The JAX trainer's optimizer is an optax chain with injected hyperparameters:
backbone scale (the two-phase freeze), then ``clip_by_global_norm``, then the
base optimizer, with ``learning_rate``, ``max_norm`` and ``backbone_scale``
set by the engine between epochs. ``OptaxChain`` reproduces that chain's
arithmetic, step for step, where ``torch.optim`` would differ:

  * AMSGrad keeps the running maximum of the *bias-corrected* second moment
    (``optax.scale_by_amsgrad``); ``torch.optim.AdamW(amsgrad=True)`` keeps
    the maximum of the uncorrected one.
  * Clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``
    (``clip_grad_norm_`` uses ``max_norm / (norm + 1e-6)``).
  * A frozen backbone (``backbone_scale`` 0) gets zero gradients, not none:
    the step count and the moments advance, and decoupled weight decay
    still shrinks the frozen parameters, as in optax.

The arithmetic runs as multi-tensor (``torch._foreach_*``) operations, a few
launches per step whatever the number of parameters.

As in optax's ``inject_hyperparams``, the hyperparameters and the step
count are device tensors (0-d, on the parameters' device), allocated once
and written in place (``set_hyperparam`` fills them), and the bias
corrections and RAdam's rectification branch are computed from the count
on the device. A step therefore reads nothing from the host, and a
captured CUDA graph of it (``train/steps.py``) reads the current values at
the same addresses on every replay. The host keeps the values as set, so
``hyperparams`` and ``state_dict`` read no device memory but the count.
"""

from __future__ import annotations

import copy
import types

import numpy as np
import torch
import torch.nn as nn

from facerec_torch.config import OptimizerConfig
from facerec_torch.models.arcface import init_like_flax

# Model-aware default clip norms (reference training_utils.py:151-176).
MODEL_CLIP_NORMS = {"siamese": 0.5, "attention": 0.75, "arcface": 0.3}
BACKBONE_KEYS = ("backbone",)
BASE_OPTIMIZERS = ("adam", "adamw", "radam", "sgd")
EPS = 1e-8  # optax's eps for adam, adamw, amsgrad and radam; eps_root is 0
RADAM_THRESHOLD = 5.0


def _f32(v: float) -> float:
    """The f32 value of ``v`` (optax holds hyperparameters as f32 arrays)."""
    return float(np.float32(v))


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (a 0-d f32 tensor). On
    the CPU each tensor's norm accumulates in f64: PyTorch's f32 CPU norm
    sums in sequence, 9e-4 off on the siamese ``fc1`` gradient's 18.9M
    elements; the card's kernel reduces in a tree."""
    dtype = torch.float64 if tensors[0].device.type == "cpu" else None
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors, 2, dtype=dtype))).float()


class OptaxChain:
    """The JAX trainer's optimizer over ``named_params`` (``(name,
    parameter)`` pairs): ``step(grads)`` updates the parameters in place.
    ``hyperparams`` holds ``learning_rate``, ``max_norm`` and
    ``backbone_scale`` as set (read-only: ``set_hyperparam`` writes them);
    ``state_dict`` holds them, the step count and the moments."""

    def __init__(self, named_params, config: OptimizerConfig, model_type: str = "baseline"):
        self.config = config
        self.kind = config.name.lower()
        if self.kind not in BASE_OPTIMIZERS:
            raise ValueError(f"Unknown optimizer: {config.name}")
        self.amsgrad = self.kind == "adamw" and config.amsgrad
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.backbone = [any(k in BACKBONE_KEYS for k in n.split(".")) for n in self.names]
        dev = self.params[0].device
        self._hyperparams = {
            "learning_rate": config.learning_rate,
            "max_norm": MODEL_CLIP_NORMS.get(model_type, config.grad_clip_norm),
            "backbone_scale": 1.0,
        }
        self.hp_tensors = {k: torch.full((), _f32(v), device=dev)
                           for k, v in self._hyperparams.items()}
        self.count_tensor = torch.zeros((), dtype=torch.int32, device=dev)
        self._decay = {b: torch.full((), _f32(b), device=dev) for b in (config.beta1, config.beta2)}
        slots = ["trace"] if self.kind == "sgd" else ["mu", "nu"] + (["nu_max"] if self.amsgrad else [])
        self.slots = {s: [torch.zeros_like(p) for p in self.params] for s in slots}

    @property
    def hyperparams(self) -> types.MappingProxyType:
        return types.MappingProxyType(self._hyperparams)

    @property
    def count(self) -> int:
        """Steps taken (read from the device)."""
        return int(self.count_tensor)

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        """One update from ``grads`` (one tensor per parameter, in order;
        modified in place)."""
        cfg, hp = self.config, self.hp_tensors
        g = list(grads)
        frozen = [x for x, b in zip(g, self.backbone) if b]
        if frozen:  # x 1.0 is exact: no host test of the scale
            torch._foreach_mul_(frozen, hp["backbone_scale"])
        if cfg.use_grad_clip:
            norm = global_norm(g)
            under = norm < hp["max_norm"]
            torch._foreach_div_(g, torch.where(under, 1.0, norm))
            torch._foreach_mul_(g, torch.where(under, 1.0, hp["max_norm"]))
        self.count_tensor.add_(1)
        updates = self._base_updates(g)
        torch._foreach_mul_(updates, torch.neg(hp["learning_rate"]))
        torch._foreach_add_(self.params, updates)

    def _bias_correction(self, decay: float, t: torch.Tensor) -> torch.Tensor:
        """``1 - decay ** count`` in f32, as optax computes it (numpy's f32
        ``**`` on the CPU; one code path whether captured or not)."""
        return 1.0 - self._decay[decay] ** t

    def _base_updates(self, g: list[torch.Tensor]) -> list[torch.Tensor]:
        cfg = self.config
        if self.kind == "sgd":
            trace = self.slots["trace"]
            torch._foreach_mul_(trace, cfg.momentum)
            torch._foreach_add_(trace, g)
            return [x.clone() for x in trace]
        t = self.count_tensor.float()
        b1, b2 = cfg.beta1, cfg.beta2
        mu, nu = self.slots["mu"], self.slots["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        mu_hat = torch._foreach_div(mu, self._bias_correction(b1, t))
        nu_hat = torch._foreach_div(nu, self._bias_correction(b2, t))
        if self.amsgrad:
            torch._foreach_maximum_(self.slots["nu_max"], nu_hat)
            nu_hat = self.slots["nu_max"]
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, EPS)
        if self.kind == "radam":
            # optax's branch on ro, as a select: below the threshold the
            # update is mu_hat (r and the denominator become exactly 1)
            ro = self._radam_ro(b2, t)
            rectify = ro >= RADAM_THRESHOLD
            torch._foreach_mul_(mu_hat, torch.where(rectify, self._radam_r(ro, b2), 1.0))
            on = rectify.float()
            torch._foreach_mul_(denom, on)
            torch._foreach_add_(denom, 1.0 - on)
        updates = torch._foreach_div(mu_hat, denom)
        if self.kind == "adamw":
            torch._foreach_add_(updates, self.params, alpha=cfg.weight_decay)
        return updates

    def _radam_ro(self, b2: float, t: torch.Tensor) -> torch.Tensor:
        """optax's ``ro = ro_inf - 2 t b2^t / (1 - b2^t)``, in f32: near the
        threshold (step 5 at b2 0.999) the rounding decides the branch."""
        ro_inf = _f32(2.0 / (1.0 - b2) - 1.0)
        b2t = self._decay[b2] ** t
        return ro_inf - (2.0 * t) * b2t / (1.0 - b2t)

    @staticmethod
    def _radam_r(ro: torch.Tensor, b2: float) -> torch.Tensor:
        f = np.float32
        ro_inf = f(2.0 / (1.0 - b2) - 1.0)
        return torch.sqrt((ro - 4.0) * (ro - 2.0) * float(ro_inf)
                          / (float((ro_inf - f(4)) * (ro_inf - f(2))) * ro))

    def state_dict(self) -> dict:
        return {"count": self.count, "hyperparams": dict(self._hyperparams),
                "slots": {s: dict(zip(self.names, v)) for s, v in self.slots.items()}}

    def load_state_dict(self, d: dict) -> None:
        """In place: a captured step goes on reading the same tensors."""
        self.count_tensor.fill_(int(d["count"]))
        for k, v in d["hyperparams"].items():
            set_hyperparam(self, k, v)
        with torch.no_grad():
            for s, tensors in self.slots.items():
                saved = d["slots"][s]
                for name, t in zip(self.names, tensors):
                    t.copy_(saved[name])


def make_optimizer(named_params, config: OptimizerConfig, model_type: str = "baseline") -> OptaxChain:
    """The chain with injected hyperparameters: ``learning_rate``
    (scheduler-driven), ``max_norm`` (model-aware clip), ``backbone_scale``
    (two-phase freeze)."""
    return OptaxChain(named_params, config, model_type)


def set_hyperparam(opt_state: OptaxChain, name: str, value: float) -> OptaxChain:
    """Set an injected hyperparameter (host-side, between steps): the host
    value, and the device tensor in place."""
    if name not in opt_state.hyperparams:
        raise KeyError(name)
    opt_state._hyperparams[name] = float(value)
    opt_state.hp_tensors[name].fill_(_f32(value))
    return opt_state


class TrainState:
    """What the train step reads and advances. ``model`` holds the
    parameters and the BatchNorm statistics; ``opt_state`` the optimizer;
    ``seed`` and ``step`` seed each step's dropout draws, so a resumed run
    draws what an uninterrupted one would.

    The draws come from one generator on the parameters' device
    (``generator``), reseeded to ``seed * 1_000_003 + step`` before every
    step (``dropout_generator``): a replayed CUDA graph that registered it
    draws what a fresh generator with that seed draws. ``epoch`` (ArcFace's
    margin schedule reads it) is set on the host and held in a 0-d device
    tensor, ``epoch_tensor``, written in place."""

    def __init__(self, model: nn.Module, opt_state: OptaxChain, seed: int, step: int = 0,
                 epoch: float = 0.0):
        self.model = model
        self.opt_state = opt_state
        self.seed = seed
        self.step = step
        self.device = opt_state.params[0].device
        self.generator = torch.Generator(device=self.device)
        self.epoch_tensor = torch.zeros((), device=self.device)
        self.epoch = epoch

    @property
    def epoch(self) -> float:
        return self._epoch

    @epoch.setter
    def epoch(self, value: float) -> None:
        self._epoch = float(value)
        self.epoch_tensor.fill_(self._epoch)

    def dropout_generator(self) -> torch.Generator:
        """``generator``, seeded from (seed, step)."""
        self.generator.manual_seed((self.seed * 1_000_003 + self.step) % (1 << 63))
        return self.generator

    def __deepcopy__(self, memo: dict) -> "TrainState":
        """A copy with its own model, optimizer (over the copy's parameters),
        generator and epoch tensor."""
        return TrainState(copy.deepcopy(self.model, memo), copy.deepcopy(self.opt_state, memo),
                          self.seed, self.step, self.epoch)


def create_train_state(model: nn.Module, config, model_type: str,
                       device: torch.device) -> TrainState:
    """Initialise ``model`` from ``config.seed`` (Flax's defaults), move it
    to ``device`` and build its optimizer."""
    init_like_flax(model, torch.Generator().manual_seed(config.seed))
    model.to(device)
    if device.type == "cuda":
        model.to(memory_format=torch.channels_last)
    opt = make_optimizer(model.named_parameters(), config.optimizer, model_type)
    return TrainState(model=model, opt_state=opt, seed=config.seed)
