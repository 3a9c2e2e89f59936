"""Wrapper of the crop-and-resize kernel ``csrc/crop_resize.cu``.

``warp_fast.crop_resize_matmul_batched`` resamples each box with two dense
matmuls against bilinear weight matrices, but each weight row holds at most
two nonzeros: the taps ``floor(pos)`` and ``floor(pos) + 1`` of the line's
source position. The kernel takes just those two taps per axis, with the
matmul route's bf16 weights, its bf16 rounding of the source and of the
row-pass intermediate, and gives the same values bit for bit: every product
of two bf16 values is exact in f32, so a sum of at most two nonzero products
and exact zeros rounds the same in any order. ``crop_taps`` is the plain
statement of the per-line taps, which the kernel repeats op by op.

Sources whose values are not finite differ: the matmul multiplies every
weight, zeros included, by every source value, so a NaN or infinity
anywhere in a frame spreads over all its crops; the kernel reads only the
taps. A non-finite box coordinate gives NaN on the rows or columns whose
position is NaN in both.
"""

from __future__ import annotations

import torch

from facerec_torch.ops import kernels
from facerec_torch.ops.warp_fast import crop_resize_matmul_batched

MAX_CHANNELS = 4  # kMaxC in csrc/crop_resize.cu
_DTYPES = (torch.float32, torch.bfloat16)


def crop_taps(start: torch.Tensor, scale: torch.Tensor, out: int, n_in: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per output line of ``warp_fast._bilinear_weights(start, scale, out,
    n_in)``: int64 source indices [..., out, 2] and bf16 weights
    [..., out, 2], the two entries of the line's weight row that may be
    nonzero. The second tap past the edge (``pos == n_in - 1``, where its
    weight is 0) points at the first; a NaN position points at 0 with NaN
    weights."""
    p = torch.arange(out, dtype=torch.float32, device=start.device)
    pos = start[..., None] + scale[..., None] * p
    pos = pos.clamp(0.0, n_in - 1.0)
    s0 = torch.floor(pos)
    s1 = s0 + 1.0
    w0 = torch.clamp(1.0 - (pos - s0).abs(), min=0.0)
    w1 = torch.clamp(1.0 - (pos - s1).abs(), min=0.0)
    s1 = torch.where(s1 > n_in - 1.0, s0, s1)  # past the edge: pos == n_in - 1, w1 == 0
    nan = torch.isnan(pos)
    idx = torch.stack([s0, s1], dim=-1).masked_fill(nan[..., None], 0.0).long()
    return idx, torch.stack([w0, w1], dim=-1).to(torch.bfloat16)


def crop_resize_kernel(images: torch.Tensor, boxes: torch.Tensor, out_size: int,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Drop-in for ``warp_fast.crop_resize_matmul_batched``: images
    [B, H, W, C] (f32 or bf16, contiguous, C <= 4), boxes [B, N, 4]
    (x1, y1, x2, y2) -> [B, N, out, out, C] in ``out_dtype`` (f32 or bf16).
    The CUDA kernel on CUDA tensors, where ``out * C`` must be a multiple of
    4 (f32) or 8 (bf16) values; the matmul route on CPU tensors."""
    kernels.note("crop_resize", images, boxes, out_size, out_dtype)
    if not images.is_cuda:
        return crop_resize_matmul_batched(images, boxes, out_size, out_dtype)
    if images.dim() != 4 or boxes.dim() != 3 or boxes.shape[0] != images.shape[0] \
            or boxes.shape[2] != 4:
        raise ValueError(f"images {tuple(images.shape)} and boxes {tuple(boxes.shape)} do not "
                         "make [B, H, W, C] and [B, N, 4]")
    b, h, w, c = images.shape
    n = boxes.shape[1]
    if not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"the kernel takes 1 to {MAX_CHANNELS} channels, not {c}")
    if images.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"the kernel reads and writes f32 or bf16, not {images.dtype} and "
                        f"{out_dtype}")
    if not images.is_contiguous():
        raise ValueError("images must be contiguous")
    if boxes.device != images.device:
        raise ValueError(f"boxes on {boxes.device}, images on {images.device}")
    if h < 1 or w < 1 or out_size < 1:
        raise ValueError(f"cannot crop {out_size} px from {h} x {w} frames")
    vec = 16 // out_dtype.itemsize
    if out_size * c % vec:
        raise ValueError(f"the kernel writes rows of whole 16-byte vectors: {out_size} px of "
                         f"{c} channels is not a multiple of {vec} {out_dtype} values")
    dev = images.device
    out = torch.empty((b, n, out_size, out_size, c), dtype=out_dtype, device=dev)
    if b * n == 0:
        return out
    bx = boxes.float().contiguous()
    with torch.cuda.device(dev):  # the launcher sizes and launches on the current device
        kernels.launch("crop_resize", images.data_ptr(), int(images.dtype == torch.bfloat16),
                       bx.data_ptr(), b, n, h, w, c, out_size, out.data_ptr(),
                       int(out_dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    return out
