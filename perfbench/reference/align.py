"""Plain eye-levelling align of the serve cells: each face's box, widened
by a margin to a padded patch, is resampled so that the line between the
eyes turns level (the angle clamped to +-15 degrees) about the eyes' centre,
and the centre ``size`` x ``size`` of the patch is the crop.

The rotation is the exact decomposition R = Diag(c, 1/c) . ShY(s c) .
ShX(-s / c): the diagonal folds into the crop box, and the two shears
resample each line by linear interpolation, in f32. This is the arithmetic
the served align states (a matrix-product crop, then a y and an x shear),
computed without rounding to bf16."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.mtcnn import crop_resize
from perfbench.reference.precision import Precision

MAX_ANGLE_DEG = 15.0
PAD = 0.15


def _shear(patch, slope, const, k_lo, k_hi, axis):
    """Shift line l of ``patch`` [N, P, P, C] along ``axis`` (2: x, one
    shift a row; 1: y, one shift a column) by slope * (l - centre) + const,
    clamped to [k_lo, k_hi - 1], sampling by linear interpolation with zero
    outside the patch."""
    n, p = patch.shape[0], patch.shape[1]
    other = torch.arange(p, dtype=torch.float32, device=patch.device) - (p - 1) / 2.0
    shift = (slope[:, None] * other[None, :] + const[:, None]).clamp(k_lo, k_hi - 1.0)  # [N, P]
    base = torch.floor(shift)
    frac = shift - base
    pos = torch.arange(p, device=patch.device)
    # output index o along the axis reads the input at o + shift
    src = pos[None, None, :] + base[:, :, None].long()  # [N, lines, P]
    if axis == 2:  # rows are lines, x varies
        lines = patch  # [N, P(y), P(x), C]
    else:  # columns are lines
        lines = patch.permute(0, 2, 1, 3)
    padded = F.pad(lines, (0, 0, 1, 1))  # zero guard on both ends of each line

    def take(ix):
        ok = (ix >= 0) & (ix < p)
        g = torch.gather(padded, 2, (ix.clamp(-1, p) + 1)[..., None].expand(n, p, p, lines.shape[-1]))
        return torch.where(ok[..., None], g, 0.0)

    out = (1.0 - frac)[:, :, None, None] * take(src) + frac[:, :, None, None] * take(src + 1)
    return out if axis == 2 else out.permute(0, 2, 1, 3)


def _shear_params(phi, centers, p, max_rad):
    cosp, sinp = torch.cos(phi), torch.sin(phi)
    cap = 0.1 * p
    rcx = torch.clamp(centers[:, 0] - (p - 1) / 2.0, -cap, cap)
    rcy = torch.clamp(centers[:, 1] - (p - 1) / 2.0, -cap, cap)
    tx = (1 - cosp) * rcx + sinp * rcy
    ty = -sinp * rcx + (1 - cosp) * rcy
    cmin, smax = math.cos(max_rad), math.sin(max_rad)
    tmax = (smax + (1 - cmin)) * cap
    ky = int(math.ceil(smax * cmin * p / 2 + (1.0 + smax) * tmax)) + 1
    kx = int(math.ceil((smax / cmin) * (p / 2) + tmax / cmin)) + 1
    return sinp * cosp, cosp * ty - sinp * tx, -sinp / cosp, tx / cosp, ky, kx


def align(p: Precision, frames: torch.Tensor, boxes: torch.Tensor, landmarks: torch.Tensor,
          size: int) -> torch.Tensor:
    """frames [B, H, W, 3], boxes [B, F, 4], landmarks [B, F, 5, 2] ->
    crops [B, F, size, size, 3] in f32."""
    b, f = boxes.shape[0], boxes.shape[1]
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    bw, bh = torch.clamp(x2 - x1, min=1.0), torch.clamp(y2 - y1, min=1.0)
    ps = int(round(size * (1 + 2 * PAD) / 8)) * 8
    extra = (ps - size) / (2.0 * size)
    bx0, by0, bx2, by2 = x1 - extra * bw, y1 - extra * bh, x2 + extra * bw, y2 + extra * bh
    lm = landmarks.float()
    le, re = lm[..., 0, :], lm[..., 1, :]
    angle = torch.atan2(re[..., 1] - le[..., 1], re[..., 0] - le[..., 0])
    centers = torch.stack([((le[..., 0] + re[..., 0]) / 2 - bx0) / (bx2 - bx0) * ps,
                           ((le[..., 1] + re[..., 1]) / 2 - by0) / (by2 - by0) * ps], dim=-1)
    max_rad = math.radians(MAX_ANGLE_DEG)
    phi = torch.clamp(angle, -max_rad, max_rad)
    cosp = torch.cos(phi)
    cp = (ps - 1) / 2.0
    dx1 = bx0 + (bx2 - bx0) / ps * cp * (1.0 - cosp)
    dy1 = by0 + (by2 - by0) / ps * cp * (1.0 - 1.0 / cosp)
    box_d = torch.stack([dx1, dy1, dx1 + cosp * (bx2 - bx0), dy1 + (by2 - by0) / cosp], dim=-1)
    patches = crop_resize(p, frames, box_d, ps).reshape(b * f, ps, ps, 3)
    sy, cy, sx, cx, ky, kx = _shear_params(phi.reshape(-1), centers.reshape(-1, 2), ps, max_rad)
    out = _shear(patches, sy, cy, -ky, ky, axis=1)
    out = _shear(out, sx, cx, -kx, kx, axis=2)
    off = (ps - size) // 2
    return out[:, off:off + size, off:off + size, :].reshape(b, f, size, size, 3)
