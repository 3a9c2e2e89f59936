"""Masked, static-shape non-maximum suppression (counterpart of
``facerec_tpu/ops/nms.py``), batched over any leading dimensions.

Boxes are a padded [..., N, 4] buffer with a validity mask. Greedy NMS runs
as the fixed point of "box i survives iff no surviving higher-scored box
overlaps it past the threshold", ties going to the lower index. The
suppression from the boxes is ``nms_suppress``: on CUDA tensors it launches
the kernel ``csrc/nms_fixed_point.cu``, which builds each row's suppression
bits from its boxes and scores in shared memory and iterates until a round
changes nothing without the host waiting (the counterpart of the JAX
version's overlap matrix and ``while_loop``), so the step it sits in can be
captured in a CUDA graph. On CPU tensors it takes the plain version,
``nms_suppress_plain``: the overlap matrix and the score order as PyTorch
ops, then ``nms_fixed_point_plain`` over the boolean suppression matrix,
``unroll`` rounds per block and one host read per block to check
convergence (rounds past the fixed point are idempotent, so the result does
not depend on ``unroll``).
"""

from __future__ import annotations

import ctypes

import torch

from facerec_torch import build
from facerec_torch.ops.gallery import topk_stable

MAX_N = 1024  # kMaxN in csrc/nms_fixed_point.cu
MODES = ("union", "min", "dupmin")  # the kernel's mode numbers, in order


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
    m = min(max_out if max_out is not None else n, n)
    rows = valid.numel() // n if n else 0
    keep, _ = nms_suppress(boxes.reshape(rows, n, 4), s0.reshape(rows, n),
                           valid.reshape(rows, n), threshold, mode, unroll)
    keep = keep.reshape(valid.shape)

    top_s, idx = topk_stable(torch.where(keep, s0, neg), m)
    kept = top_s > neg
    b = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, boxes.shape[-1]))
    s = torch.where(kept, torch.gather(scores.float(), -1, idx), 0.0)
    return b, s, kept, torch.where(kept, idx, 0)


def nms_fixed_point_plain(sup: torch.Tensor, keep0: torch.Tensor, unroll: int = 4
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fixed point of ``nms_suppress_plain``: sup [M, N, N] bool (sup[m,
    i, j]: j can suppress i), keep0 [M, N] bool -> (keep [M, N] bool, rounds
    [M] int32: the rounds each row ran until one changed nothing, that one
    included). ``unroll`` rounds run per block and the host reads once per
    block whether every row has converged; at most N rounds are counted,
    the JAX loop's cap."""
    n = sup.shape[-1]

    def one_round(keep):
        return keep0 & ~torch.any(sup & keep[..., None, :], dim=-1)

    keep, it = keep0, 0
    rounds = torch.zeros(keep0.shape[:-1], dtype=torch.int32, device=keep0.device)
    done = torch.zeros(keep0.shape[:-1], dtype=torch.bool, device=keep0.device)
    while True:
        for _ in range(max(unroll, 1)):
            new = one_round(keep)
            rounds += ~done
            done |= torch.all(new == keep, dim=-1)
            keep = new
        it += max(unroll, 1)
        if bool(done.all()) or it >= n:
            break
    return keep, torch.clamp(rounds, max=n)


def nms_suppress_plain(boxes: torch.Tensor, s0: torch.Tensor, valid: torch.Tensor,
                       threshold: float, mode: str = "union", unroll: int = 4
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the NMS kernel: boxes [M, N, 4], the masked scores
    s0 [M, N] (-inf where invalid), valid [M, N] bool -> (keep [M, N] bool,
    rounds [M] int32), from ``overlap_matrix``, the score order (ties to the
    lower index) and ``nms_fixed_point_plain``."""
    n = s0.shape[-1]
    idx = torch.arange(n, device=s0.device)
    sj, si = s0[..., None, :], s0[..., :, None]
    dominates = (sj > si) | ((sj == si) & (idx[None, :] < idx[:, None]))
    sup = (overlap_matrix(boxes, mode) > threshold) & dominates & valid[..., None, :]
    return nms_fixed_point_plain(sup, valid & (s0 > float("-inf")), unroll)


def nms_suppress(boxes: torch.Tensor, s0: torch.Tensor, valid: torch.Tensor, threshold: float,
                 mode: str = "union", unroll: int = 4
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The suppression of ``nms_suppress_plain``: the CUDA kernel on CUDA
    tensors (f32 boxes and scores, N up to ``MAX_N``; it raises otherwise),
    the plain version on CPU tensors (``unroll`` is read only there)."""
    if not boxes.is_cuda:
        return nms_suppress_plain(boxes, s0, valid, threshold, mode, unroll)
    m, n, four = boxes.shape
    if four != 4 or tuple(s0.shape) != (m, n) or tuple(valid.shape) != (m, n):
        raise ValueError(f"boxes {tuple(boxes.shape)}, s0 {tuple(s0.shape)} and valid "
                         f"{tuple(valid.shape)} do not make [M, N, 4], [M, N] and [M, N]")
    if boxes.dtype != torch.float32 or s0.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"the NMS kernel takes f32 boxes and scores and bool valid, not "
                        f"{boxes.dtype}, {s0.dtype} and {valid.dtype}")
    if mode not in MODES:
        raise ValueError(f"unknown overlap mode {mode!r}")
    if n > MAX_N:
        raise ValueError(f"the NMS kernel takes at most {MAX_N} boxes a row, not {n}")
    dev = boxes.device
    keep = torch.empty((m, n), dtype=torch.bool, device=dev)
    rounds = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0 or n == 0:
        return keep, rounds.zero_()
    boxes, s0, valid = boxes.contiguous(), s0.contiguous(), valid.contiguous()
    with torch.cuda.device(dev):
        err = _launcher()(boxes.data_ptr(), s0.data_ptr(), valid.data_ptr(), m, n,
                          float(threshold), MODES.index(mode), keep.data_ptr(),
                          rounds.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "nms_suppress")
    nms_suppress.launches += 1
    return keep, rounds


nms_suppress.launches = 0


def _launcher():
    fn = build.library("nms_fixed_point").nms_suppress_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, ctypes.c_float, i, p, p, p]
    fn.restype = i
    return fn
