"""ArcFace angular-margin logits (counterpart of ``facerec_tpu/ops/arcface.py``).

The behaviour of the reference's ``ArcMarginProduct`` as plain functions of
an ``epoch`` scalar:

  * warmup: progress = epoch / warmup_epochs; margin_factor =
    min(0.9, progress^2); scale_factor = min(0.8, 0.3 + 0.5 progress); fixed
    at 0.9 / 0.8 after the warmup;
  * cosine logits of L2-normalised features and class centres, in full f32;
  * clamp to +-(1 - 1e-7), theta = acos;
  * easy margin: phi = cos(theta + m) where cos > 0, else cos, on the target
    class only; standard: cos(min(pi - 1e-4, theta + m));
  * scale capped at 24; training scale = min(s, 24) * min(0.8, scale_factor),
    times (0.8 - 0.5 margin_factor) more when the margin exceeds 0.4;
  * non-finite logits scrubbed to 0.

Everything here runs in f32 with autocast off. The cosine product refuses
to run on the card with TF32 matrix products on; turning them off is the
caller's precision policy.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class ArcFaceStats(NamedTuple):
    """Monitoring values (reference face_models.py:431-445 get_margin_stats)."""

    margin_factor: torch.Tensor
    scale_factor: torch.Tensor
    effective_margin: torch.Tensor
    effective_scale: torch.Tensor
    max_cos_theta: torch.Tensor
    min_cos_theta: torch.Tensor


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


def _cosines(embeddings: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Cosines of the L2-normalised rows, ``x @ w.T`` in full f32. On the
    card that needs TF32 off for matrix products (PyTorch's default); the
    precision policy is the caller's (``train_model`` sets it), so this
    refuses rather than flipping the process-wide flag."""
    if embeddings.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the ArcFace cosine product is full f32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    x = l2_normalize(embeddings.float())
    w = l2_normalize(weight.float())
    return x @ w.T


def _scalar(v: torch.Tensor | float, device) -> torch.Tensor:
    """A 0-d f32 tensor on ``device``; a Python number is filled in on the
    device (``torch.tensor(v, device=...)`` would copy from the host and
    wait for the card)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def progressive_factors(epoch: torch.Tensor | float, warmup_epochs: int,
                        device: torch.device | str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Quadratic margin ramp and linear scale ramp (face_models.py:336-348)."""
    epoch = _scalar(epoch, device)
    progress = torch.clamp(epoch / max(warmup_epochs, 1), 0.0, 1.0)
    margin_factor = torch.clamp(progress * progress, max=0.9)
    scale_factor = torch.clamp(0.3 + 0.5 * progress, max=0.8)
    in_warmup = epoch < warmup_epochs
    margin_factor = torch.where(in_warmup, margin_factor, 0.9)
    scale_factor = torch.where(in_warmup, scale_factor, 0.8)
    return margin_factor, scale_factor


def arc_margin_logits(
    embeddings: torch.Tensor,  # [B, D] (need not be normalised)
    weight: torch.Tensor,  # [C, D] class-centre weights
    labels: torch.Tensor | None,  # [B] int; required when training
    epoch: torch.Tensor | float = 0.0,
    *,
    margin: float = 0.5,
    scale: float = 32.0,
    easy_margin: bool = False,
    progressive: bool = True,
    warmup_epochs: int = 10,
    training: bool = True,
) -> tuple[torch.Tensor, ArcFaceStats]:
    """Return (scaled margin logits [B, C] f32, monitoring stats)."""
    dev = embeddings.device
    with torch.autocast(dev.type, enabled=False):
        cos_theta = _cosines(embeddings, weight)
        if training and progressive:
            margin_factor, scale_factor = progressive_factors(epoch, warmup_epochs, dev)
        else:
            margin_factor = _scalar(1.0 if not training else 0.9, dev)
            scale_factor = _scalar(0.8, dev)

        cos_safe = torch.clamp(cos_theta, -1.0 + 1e-7, 1.0 - 1e-7)
        theta = torch.acos(cos_safe)
        eff_margin = margin * margin_factor if training else _scalar(margin, dev)

        if labels is not None:
            one_hot = torch.nn.functional.one_hot(labels.long(), weight.shape[0]).bool()
            if easy_margin:
                phi = torch.where(cos_safe > 0, torch.cos(theta + eff_margin), cos_safe)
            else:
                phi = torch.cos(torch.clamp(theta + eff_margin, max=math.pi - 1e-4))
            output = torch.where(one_hot, phi, cos_safe)
        else:
            output = cos_safe

        eff_s = min(scale, 24.0)
        if training:
            eff_scale = eff_s * torch.clamp(scale_factor, max=0.8)
            if margin > 0.4:
                eff_scale = eff_scale * (0.8 - 0.5 * margin_factor)
        else:
            eff_scale = _scalar(eff_s, dev)

        output = output * eff_scale
        output = torch.where(torch.isfinite(output), output, 0.0)

        stats = ArcFaceStats(
            margin_factor=margin_factor,
            scale_factor=scale_factor,
            effective_margin=eff_margin.float(),
            effective_scale=eff_scale.float(),
            max_cos_theta=cos_theta.detach().max(),
            min_cos_theta=cos_theta.detach().min(),
        )
    return output, stats


def cosine_logits(embeddings: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain cosine-similarity logits against the class centres: the ArcFace
    eval path."""
    with torch.autocast(embeddings.device.type, enabled=False):
        return _cosines(embeddings, weight)
