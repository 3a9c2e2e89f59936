"""Wrapper of the 2-shear rotation kernel ``csrc/shear_rotate.cu``.

Counterpart of ``facerec_tpu/ops/pallas_warp.py``. The wrapper computes each
patch's slopes and consts (``warp_fast._shear_params``, on [N] vectors) and
the kernel computes every line's taps from them. Because the coarse slots
are one-hot and only two fine taps carry weight, a line's taps reduce to one
integer offset ``8*c + fb`` and the two bf16 weights ``1 - ff`` and ``ff``
(the values ``_shear`` rounds its tap weights to). ``line_taps`` is the plain
statement of that arithmetic, which the kernel repeats op by op.
"""

from __future__ import annotations

import math

import torch

from facerec_torch.ops import kernels
from facerec_torch.ops.warp_fast import COARSE, _shear_lines, _shear_params, rotate_patches

MAX_CHANNELS = 4  # kMaxC in csrc/shear_rotate.cu


def line_taps(slope: torch.Tensor, const: torch.Tensor, p: int, k_lo: int, k_hi: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per line: int32 offset [N, P] and bf16 weights [N, P, 2]."""
    c, fb, ff = _shear_lines(slope, const, p, k_lo, k_hi)
    offset = (c * COARSE + fb).to(torch.int32)
    weights = torch.stack([1.0 - ff, ff], dim=-1).to(torch.bfloat16)
    return offset.contiguous(), weights.contiguous()


def rotate_patches_kernel(patches: torch.Tensor, angles: torch.Tensor,
                          centers: torch.Tensor, out_size: int,
                          max_angle_deg: float = 15.0) -> torch.Tensor:
    """Drop-in for ``warp_fast.rotate_patches``: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors. patches [N, P, P, C],
    angles [N], centres [N, 2] -> [N, out, out, C] in the patch dtype."""
    kernels.note("shear_rotate", patches, angles, centers, out_size, max_angle_deg)
    if not patches.is_cuda:
        return rotate_patches(patches, angles, centers, out_size, max_angle_deg)
    return rotate_patches_tiled(patches, angles, centers, out_size, max_angle_deg)


def rotate_patches_tiled(patches: torch.Tensor, angles: torch.Tensor, centers: torch.Tensor,
                         out_size: int, max_angle_deg: float = 15.0, segments: int = 0,
                         blocks_per_sm: int = 0) -> torch.Tensor:
    """The kernel on CUDA tensors with its tiling forced: ``segments`` row
    ranges per patch (1 to ``out_size``) and ``blocks_per_sm`` (1 or 2); 0
    leaves each to the launcher, as ``rotate_patches_kernel`` does. For
    measuring the launcher's choice."""
    n, p, p2, ch = patches.shape
    if p != p2 or not 0 < out_size <= p:
        raise ValueError(f"patches {tuple(patches.shape)} cannot give a {out_size} crop")
    if not 0 < ch <= MAX_CHANNELS:
        raise ValueError(f"the kernel takes 1 to {MAX_CHANNELS} channels, not {ch}")
    out = torch.empty((n, out_size, out_size, ch), dtype=torch.bfloat16, device=patches.device)
    if n == 0:
        return out.to(patches.dtype)
    max_rad = math.radians(max_angle_deg)
    phi = torch.clamp(angles.float(), -max_rad, max_rad)
    sy, cy, sx, cx, ky, kx = _shear_params(phi, centers.float(), p, max_rad)  # [N] f32 each
    src = patches.to(torch.bfloat16).contiguous()
    with torch.cuda.device(src.device):  # the launcher sizes and launches on the current device
        kernels.launch("shear_rotate", src.data_ptr(), sy.data_ptr(), cy.data_ptr(),
                       sx.data_ptr(), cx.data_ptr(), n, p, out_size, ch, ky, kx, segments,
                       blocks_per_sm, out.data_ptr(),
                       torch.cuda.current_stream(src.device).cuda_stream)
    return out.to(patches.dtype)
