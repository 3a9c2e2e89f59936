"""Plain ArcFace training step (Deng et al. 2019) on a ResNet-18 trunk:
train-mode BatchNorm over the batch (biased variance), the 512-d embedding,
dropout, L2 normalisation, the additive angular margin logits against the
class centres with the progressive margin and scale of the configuration,
cross-entropy with label smoothing (the clip and the optimizer are
``optim``'s). All in f32 (``Precision`` rounds the products' operands for
the control).

``conv_bn``, ``bn_train``, ``update_running`` and ``margin_loss`` (the head
over a trunk's pooled features) serve any trunk trained with ArcFace's
head."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.precision import Precision
from perfbench.reference.resnet import param_shapes

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
# fixed in the port, not set by a configuration: the ArcFace loss's label
# smoothing (its loss table)
LABEL_SMOOTHING = 0.05


def param_names(embedding_dim: int = 512, num_classes: int = 18) -> list[str]:
    """The trainable leaves, in the module's order."""
    return [n for n in param_shapes(embedding_dim, num_classes)
            if n.rsplit(".", 1)[-1] not in BUFFERS]


def bn_train(x, w, prefix, stats, eps=1e-5):
    """BatchNorm over the batch; the batch's mean and biased variance go to
    ``stats[prefix]``."""
    dims = [0, *range(2, x.ndim)]
    shape = [1, -1] + [1] * (x.ndim - 2)
    mean = x.mean(dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dims, keepdim=True)
    stats[prefix] = (mean.detach().reshape(-1), var.detach().reshape(-1))
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * w[f"{prefix}.weight"].view(shape) + w[f"{prefix}.bias"].view(shape)


def conv_bn(p, x, w, conv, bn, st, stride=1, padding=0):
    """Convolution, then train-mode BatchNorm, each output held in the
    compute precision."""
    y = p.act(p.conv2d(x, w[conv], stride=stride, padding=padding))
    return p.act(bn_train(y, w, bn, st))


def _block(p, w, x, prefix, stride, st):
    y = F.relu(conv_bn(p, x, w, f"{prefix}.conv1.weight", f"{prefix}.bn1", st, stride, 1))
    y = conv_bn(p, y, w, f"{prefix}.conv2.weight", f"{prefix}.bn2", st, 1, 1)
    if f"{prefix}.downsample.0.weight" in w:
        x = conv_bn(p, x, w, f"{prefix}.downsample.0.weight", f"{prefix}.downsample.1", st,
                     stride)
    return F.relu(y + x)


def update_running(running: dict, stats: dict, momentum: float = 0.9) -> None:
    """running = momentum x running + (1 - momentum) x batch, for the mean
    and the biased variance of every BatchNorm."""
    with torch.no_grad():
        for prefix, (mean, var) in stats.items():
            running[f"{prefix}.running_mean"].lerp_(mean, 1.0 - momentum)
            running[f"{prefix}.running_var"].lerp_(var, 1.0 - momentum)


def margin_schedule(train: dict, epoch: float) -> tuple[float, float]:
    """(margin, scale) at ``epoch``: the margin ramps in quadratically and
    the scale linearly over the warm-up epochs (capped at 0.9 and 0.8 of
    their full values), the scale also shrinking by 0.8 - 0.5 x the margin
    factor where the margin is over 0.4."""
    progress = min(max(epoch / max(train["warmup_epochs"], 1), 0.0), 1.0)
    mf = min(progress * progress, 0.9) if epoch < train["warmup_epochs"] else 0.9
    sf = min(0.3 + 0.5 * progress, 0.8) if epoch < train["warmup_epochs"] else 0.8
    scale = min(train["scale"], 24.0) * min(sf, 0.8)
    if train["margin"] > 0.4:
        scale *= 0.8 - 0.5 * mf
    return train["margin"] * mf, scale


def loss(p: Precision, w: dict, images: torch.Tensor, labels: torch.Tensor,
         keep: torch.Tensor, train: dict, epoch: float = 0.0,
         mask: torch.Tensor | None = None, stats: dict | None = None) -> torch.Tensor:
    """The batch's mean loss (over ``mask``'s rows where given). images
    [B, S, S, 3], labels [B], keep [B, D] the dropout mask; each
    BatchNorm's batch statistics go to ``stats``."""
    st = {} if stats is None else stats
    x = p.act(images.float().permute(0, 3, 1, 2))
    x = F.relu(conv_bn(p, x, w, "backbone.conv1.weight", "backbone.bn1", st, 2, 3))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for li in range(1, 5):
        x = _block(p, w, x, f"backbone.layer{li}.0", 1 if li == 1 else 2, st)
        x = _block(p, w, x, f"backbone.layer{li}.1", 1, st)
    return margin_loss(p, w, x.mean(dim=(2, 3)), labels, keep, train, epoch, mask, st)


def margin_loss(p: Precision, w: dict, pooled: torch.Tensor, labels: torch.Tensor,
                keep: torch.Tensor, train: dict, epoch: float = 0.0,
                mask: torch.Tensor | None = None, stats: dict | None = None) -> torch.Tensor:
    """ArcFace's head over a trunk's pooled features [B, F]: the projection
    ``embedding``, BatchNorm ``bn``, dropout (``keep``), L2 normalisation,
    the margin logits against ``arc_weight`` and the smoothed
    cross-entropy; the batch's mean loss (over ``mask``'s rows)."""
    st = {} if stats is None else stats
    x = p.act(p.linear(pooled, w["embedding.weight"]))
    x = p.act(bn_train(x, w, "bn", st))
    rate = train["dropout"]
    x = torch.where(keep, x / (1.0 - rate), 0.0)
    x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
    c = w["arc_weight"]
    c = c / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True), min=1e-12)
    cos = torch.clamp(p.matmul(x, c.T), -1.0 + 1e-7, 1.0 - 1e-7)
    margin, scale = margin_schedule(train, epoch)
    phi = torch.cos(torch.clamp(torch.acos(cos) + margin, max=math.pi - 1e-4))
    onehot = F.one_hot(labels.long(), c.shape[0]).bool()
    logits = torch.where(onehot, phi, cos) * scale
    target = F.one_hot(labels.long(), c.shape[0]).float()
    target = target * (1.0 - LABEL_SMOOTHING) + LABEL_SMOOTHING / c.shape[0]
    per = -(target * F.log_softmax(logits, dim=-1)).sum(-1)
    if mask is None:
        return per.mean()
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)

