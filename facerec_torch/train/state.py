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
"""

from __future__ import annotations

import dataclasses

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


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in f32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


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
    ``backbone_scale``; ``state_dict`` holds them, the step count and the
    moments."""

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
        self.hyperparams = {
            "learning_rate": config.learning_rate,
            "max_norm": MODEL_CLIP_NORMS.get(model_type, config.grad_clip_norm),
            "backbone_scale": 1.0,
        }
        self.count = 0
        slots = ["trace"] if self.kind == "sgd" else ["mu", "nu"] + (["nu_max"] if self.amsgrad else [])
        self.slots = {s: [torch.zeros_like(p) for p in self.params] for s in slots}

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        """One update from ``grads`` (one tensor per parameter, in order;
        modified in place)."""
        cfg, hp = self.config, self.hyperparams
        g = list(grads)
        scale = _f32(hp["backbone_scale"])
        frozen = [x for x, b in zip(g, self.backbone) if b]
        if scale != 1.0 and frozen:
            torch._foreach_mul_(frozen, scale)
        if cfg.use_grad_clip:
            norm = global_norm(g)
            max_norm = torch.full((), _f32(hp["max_norm"]), device=norm.device)
            under = norm < max_norm
            torch._foreach_div_(g, torch.where(under, 1.0, norm))
            torch._foreach_mul_(g, torch.where(under, 1.0, max_norm))
        self.count += 1
        updates = self._base_updates(g)
        torch._foreach_mul_(updates, -_f32(hp["learning_rate"]))
        torch._foreach_add_(self.params, updates)

    def _base_updates(self, g: list[torch.Tensor]) -> list[torch.Tensor]:
        cfg, t = self.config, self.count
        if self.kind == "sgd":
            trace = self.slots["trace"]
            torch._foreach_mul_(trace, cfg.momentum)
            torch._foreach_add_(trace, g)
            return [x.clone() for x in trace]
        b1, b2 = cfg.beta1, cfg.beta2
        mu, nu = self.slots["mu"], self.slots["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, t))
        nu_hat = torch._foreach_div(nu, _bias_correction(b2, t))
        if self.amsgrad:
            torch._foreach_maximum_(self.slots["nu_max"], nu_hat)
            nu_hat = self.slots["nu_max"]
        if self.kind == "radam":
            ro = self._radam_ro(b2, t)
            if ro < RADAM_THRESHOLD:
                return mu_hat
            torch._foreach_mul_(mu_hat, self._radam_r(ro, b2))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, EPS)
        updates = torch._foreach_div(mu_hat, denom)
        if self.kind == "adamw":
            torch._foreach_add_(updates, self.params, alpha=cfg.weight_decay)
        return updates

    @staticmethod
    def _radam_ro(b2: float, t: int) -> float:
        """optax's ``ro = ro_inf - 2 t b2^t / (1 - b2^t)``, in f32: near the
        threshold (step 5 at b2 0.999) the rounding decides the branch."""
        f = np.float32
        ro_inf = f(2.0 / (1.0 - b2) - 1.0)
        b2t = f(b2) ** f(t)
        return float(ro_inf - f(2 * t) * b2t / (f(1) - b2t))

    @staticmethod
    def _radam_r(ro: float, b2: float) -> float:
        f = np.float32
        ro_inf = f(2.0 / (1.0 - b2) - 1.0)
        ro = f(ro)
        return float(np.sqrt((ro - f(4)) * (ro - f(2)) * ro_inf
                             / ((ro_inf - f(4)) * (ro_inf - f(2)) * ro)))

    def state_dict(self) -> dict:
        return {"count": self.count, "hyperparams": dict(self.hyperparams),
                "slots": {s: dict(zip(self.names, v)) for s, v in self.slots.items()}}

    def load_state_dict(self, d: dict) -> None:
        self.count = int(d["count"])
        self.hyperparams.update({k: float(v) for k, v in d["hyperparams"].items()})
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
    """Set an injected hyperparameter (host-side, between epochs)."""
    if name not in opt_state.hyperparams:
        raise KeyError(name)
    opt_state.hyperparams[name] = float(value)
    return opt_state


@dataclasses.dataclass
class TrainState:
    """What the train step reads and advances. ``model`` holds the
    parameters and the BatchNorm statistics; ``opt_state`` the optimizer;
    ``seed`` and ``step`` seed each step's dropout draws, so a resumed run
    draws what an uninterrupted one would."""

    model: nn.Module
    opt_state: OptaxChain
    seed: int
    step: int = 0
    epoch: float = 0.0

    def dropout_generator(self, device: torch.device) -> torch.Generator:
        """A generator on ``device`` seeded from (seed, step)."""
        gen = torch.Generator(device=device)
        gen.manual_seed((self.seed * 1_000_003 + self.step) % (1 << 63))
        return gen


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
