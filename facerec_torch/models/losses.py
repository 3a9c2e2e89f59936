"""Loss functions (counterpart of ``facerec_tpu/models/losses.py``).

Every loss takes an optional ``mask`` ([B] in {0, 1}) so that the padded
tail of the last batch contributes nothing. Losses are computed in f32
(in f64 for f64 inputs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from facerec_torch.ops.arcface import at_least_f32, l2_normalize


def _masked_mean(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return x.mean()
    mask = mask.to(x.dtype)
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-entropy with label smoothing (0.1 for the classifiers, 0.05 for
    ArcFace)."""
    logits = at_least_f32(logits)
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    if label_smoothing > 0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
    losses = -(onehot * F.log_softmax(logits, dim=-1)).sum(-1)
    return _masked_mean(losses, mask)


def contrastive_loss(emb_a: torch.Tensor, emb_b: torch.Tensor, same_label: torch.Tensor,
                     margin: float = 2.0, pos_weight: float = 1.2, neg_weight: float = 0.8,
                     mask: torch.Tensor | None = None, eps: float = 1e-8) -> torch.Tensor:
    """Contrastive loss with label 1 = same identity: same pairs pull in by
    distance^2 (times ``pos_weight``), different pairs are pushed out to at
    least ``margin`` (times ``neg_weight``)."""
    a = l2_normalize(emb_a.float())
    b = l2_normalize(emb_b.float())
    dist = torch.sqrt(torch.clamp(((a - b) ** 2).sum(-1), min=eps ** 2))
    same = same_label.float()
    loss_same = same * dist ** 2 * pos_weight
    loss_diff = (1.0 - same) * torch.clamp(margin - dist, min=0.0) ** 2 * neg_weight
    return _masked_mean(loss_same + loss_diff, mask)


def pairwise_distance(emb_a: torch.Tensor, emb_b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return torch.sqrt(torch.clamp(((emb_a - emb_b) ** 2).sum(-1), min=eps))


LOSS_CONFIG = {
    # model_type -> (loss name, kwargs)  (reference get_criterion face_models.py:815-830)
    "baseline": ("cross_entropy", {"label_smoothing": 0.1}),
    "cnn": ("cross_entropy", {"label_smoothing": 0.1}),
    "attention": ("cross_entropy", {"label_smoothing": 0.1}),
    "hybrid": ("cross_entropy", {"label_smoothing": 0.1}),
    "ensemble": ("cross_entropy", {"label_smoothing": 0.1}),
    "siamese": ("contrastive", {"margin": 2.0, "pos_weight": 1.2, "neg_weight": 0.8}),
    "arcface": ("cross_entropy", {"label_smoothing": 0.05}),
}
