"""Masked, static-shape non-maximum suppression (counterpart of
``facerec_tpu/ops/nms.py``), batched over any leading dimensions.

Boxes are a padded [..., N, 4] buffer with a validity mask. Greedy NMS runs
as the fixed point of "box i survives iff no surviving higher-scored box
overlaps it past the threshold", ties going to the lower index. The JAX
version iterates in a ``while_loop``; here ``unroll`` rounds run per block
and convergence is checked once per block, which costs one host read per
block (rounds past the fixed point are idempotent, so the result does not
depend on ``unroll``).
"""

from __future__ import annotations

import torch

from facerec_torch.ops.gallery import topk_stable


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))


def overlap_matrix(boxes: torch.Tensor, mode: str = "union") -> torch.Tensor:
    """[..., N, N] pairwise overlap. 'union' -> IoU; 'min' -> inter/min(area);
    'dupmin' -> inter/min(area) for similar-size pairs (area ratio <= 2.5)
    and IoU otherwise (the stage-1 cross-scale merge criterion)."""
    x1 = torch.maximum(boxes[..., :, None, 0], boxes[..., None, :, 0])
    y1 = torch.maximum(boxes[..., :, None, 1], boxes[..., None, :, 1])
    x2 = torch.minimum(boxes[..., :, None, 2], boxes[..., None, :, 2])
    y2 = torch.minimum(boxes[..., :, None, 3], boxes[..., None, :, 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    a = box_area(boxes)
    ai, aj = a[..., :, None], a[..., None, :]
    if mode == "min":
        denom = torch.minimum(ai, aj)
    elif mode == "dupmin":
        a_min = torch.minimum(ai, aj)
        similar = torch.maximum(ai, aj) <= 2.5 * torch.clamp(a_min, min=1e-12)
        denom = torch.where(similar, a_min, ai + aj - inter)
    elif mode == "union":
        denom = ai + aj - inter
    else:
        raise ValueError(f"unknown overlap mode {mode!r}")
    return inter / torch.clamp(denom, min=1e-12)


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
        threshold: float = 0.5, mode: str = "union", max_out: int | None = None,
        unroll: int = 4):
    """Greedy NMS over [..., N]. Returns (boxes, scores, keep, gather_idx),
    sorted by score, suppressed and invalid slots masked out and truncated
    to ``max_out`` slots."""
    n = boxes.shape[-2]
    neg = float("-inf")
    s0 = torch.where(valid, scores.float(), neg)
    ov = overlap_matrix(boxes, mode)
    m = min(max_out if max_out is not None else n, n)
    idx_r = torch.arange(n, device=boxes.device)
    sj, si = s0[..., None, :], s0[..., :, None]
    dominates = (sj > si) | ((sj == si) & (idx_r[None, :] < idx_r[:, None]))
    sup = (ov > threshold) & dominates & valid[..., None, :]  # sup[i, j]: j can kill i
    keep0 = valid & (s0 > neg)

    def one_round(keep):
        return keep0 & ~torch.any(sup & keep[..., None, :], dim=-1)

    keep, it = keep0, 0
    while True:
        for _ in range(max(unroll - 1, 0)):
            keep = one_round(keep)
        new = one_round(keep)
        it += unroll
        changed = bool(torch.any(new != keep))
        keep = new
        if not changed or it >= n:
            break

    top_s, idx = topk_stable(torch.where(keep, s0, neg), m)
    kept = top_s > neg
    b = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, boxes.shape[-1]))
    s = torch.where(kept, torch.gather(scores.float(), -1, idx), 0.0)
    return b, s, kept, torch.where(kept, idx, 0)
