"""Leslie Smith LR range test (counterpart of ``facerec_tpu/train/lr_finder.py``).

The sweep and its analysis are the JAX package's, line for line, quirks
included: the per-model end-LR caps, divergence factors and suggestion caps
(``MODEL_LR_LIMITS``), the two stop rules (non-finite loss or a loss above
``divergence_factor * 4 * min(best, loss)``, and a loss above 4x the best),
Savitzky-Golay smoothing with a 5-tap box filter when scipy raises, the
steepest negative gradient in log-LR as the suggestion, and the max LR where
the smoothed loss first passes 3x its minimum.

Unlike the JAX sweep, which advances a throwaway functional state, the
port's train step changes what it touches in place: the module's weights
and BatchNorm statistics, the optimizer's moments and count, and the step
that seeds dropout. The caller passes a probe state built for the sweep
alone (its own model from ``get_model`` and ``create_train_state``), never
the state it trains.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Iterable

import numpy as np
import torch

MODEL_LR_LIMITS = {
    # model_type -> (end_lr, divergence_factor, suggested_cap)
    "arcface": (0.01, 2.0, 5e-4),
    "siamese": (0.1, 4.0, 5e-3),
}
DEFAULTS = (1.0, 4.0, 1e-2)


class LearningRateFinder:
    def __init__(self, model_type: str = "baseline", start_lr: float = 1e-7,
                 end_lr: float | None = None, num_steps: int = 100):
        end_cap, div, cap = MODEL_LR_LIMITS.get(model_type, DEFAULTS)
        self.model_type = model_type
        self.start_lr = start_lr
        self.end_lr = end_lr if end_lr is not None else end_cap
        self.divergence_factor = div
        self.suggested_cap = cap
        self.num_steps = num_steps
        self.lrs: list[float] = []
        self.losses: list[float] = []

    def find(self, state, train_step, batches: Iterable[dict], set_lr) -> dict[str, Any]:
        """Sweep the LR exponentially from start to end over ``num_steps``
        batches. ``set_lr(opt_state, lr)`` sets the rate before each step
        (``set_hyperparam``); ``train_step(state, batch)`` advances ``state``
        in place and returns its metrics. The loss is read back every step,
        for the stop rules."""
        mult = (self.end_lr / self.start_lr) ** (1.0 / max(self.num_steps - 1, 1))
        lr = self.start_lr
        best = math.inf
        it = iter(batches)
        for i in range(self.num_steps):
            try:
                batch = next(it)
            except StopIteration:
                break
            set_lr(state.opt_state, lr)
            metrics = train_step(state, batch)
            loss = float(metrics["loss_sum"]) / max(float(metrics["count"]), 1.0)
            self.lrs.append(lr)
            self.losses.append(loss)
            if not math.isfinite(loss) or loss > self.divergence_factor * 4 * min(best, loss):
                break
            if loss > 4.0 * best:  # hard divergence stop
                break
            best = min(best, loss)
            lr *= mult
        return self.analyze()

    def analyze(self) -> dict[str, Any]:
        if len(self.losses) < 5:
            return {"suggested_lr": self.suggested_cap / 10, "max_lr": self.suggested_cap,
                    "lrs": self.lrs, "losses": self.losses, "valid": False}
        losses = np.asarray(self.losses)
        lrs = np.asarray(self.lrs)
        try:
            from scipy.signal import savgol_filter

            window = min(len(losses) // 2 * 2 - 1, 11)
            smooth = savgol_filter(losses, max(window, 5), 3) if len(losses) >= 5 else losses
        except Exception:
            k = np.ones(5) / 5
            smooth = np.convolve(losses, k, mode="same")
        grads = np.gradient(smooth, np.log10(lrs))
        steepest = int(np.argmin(grads))
        suggested = float(lrs[steepest])
        # max_lr: the LR where the smoothed loss rises to 3x its minimum
        i_min = int(np.argmin(smooth))
        max_lr = float(lrs[-1])
        for j in range(i_min, len(smooth)):
            if smooth[j] > 3.0 * smooth[i_min]:
                max_lr = float(lrs[j])
                break
        suggested = min(suggested, self.suggested_cap)
        return {"suggested_lr": suggested, "max_lr": max_lr, "steepest_idx": steepest,
                "min_loss_lr": float(lrs[i_min]), "lrs": self.lrs, "losses": self.losses,
                "valid": True}

    def save_results(self, path: str | Path, analysis: dict) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {k: v for k, v in analysis.items()}
        payload["model_type"] = self.model_type
        path.write_text(json.dumps(payload, indent=2))
        return path


def find_optimal_lr(model: torch.nn.Module, model_type: str, state, batcher, num_steps: int = 100,
                    device: str | torch.device | None = None,
                    compute_dtype: str = "bfloat16", mesh=None) -> dict[str, Any]:
    """The range test of ``model`` (already in ``state``, which the sweep
    changes) over ``batcher``'s epochs, one after the other, on ``device``
    (default: the CUDA card), at ``compute_dtype``. With ``mesh`` the sweep
    runs data-parallel (the mesh's device; each rank its slice of every
    batch): the losses, and so the stop rules and the analysis, are the
    global batch's on every rank."""
    from facerec_torch import resolve_device
    from facerec_torch.data.pipeline import prefetch_to_device
    from facerec_torch.train.state import set_hyperparam
    from facerec_torch.train.steps import make_train_step

    dev = mesh.device if mesh is not None else resolve_device(device)
    train_step = make_train_step(model_type, compute_dtype, mesh)
    finder = LearningRateFinder(model_type, num_steps=num_steps)

    def batches():
        epoch = 0
        while True:
            yield from prefetch_to_device(batcher.epoch(epoch), dev, mesh=mesh)
            epoch += 1

    return finder.find(state, train_step, batches(), lambda os, lr: set_hyperparam(os, "learning_rate", lr))
