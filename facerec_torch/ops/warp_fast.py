"""Gather-free face alignment: matmul crop+resize, then a 2-shear rotation.

Counterpart of ``facerec_tpu/ops/warp_fast.py``, in its arithmetic:

  Stage A: an axis-aligned crop+resize of each box to a padded patch
    P = S + 2*pad, as two matmuls against bilinear weight matrices. The
    operands are rounded to bf16 and multiplied in f32 (the JAX version's
    ``preferred_element_type=f32``), and the row-pass intermediate stays f32
    until it is rounded for the second product. The Diag(cos, 1/cos) factor
    of the rotation folds into the crop box. ``crop_resize_matmul_batched``
    is the plain version of the CUDA kernel ``csrc/crop_resize.cu``
    (``ops/crop_kernel.py``), which ``_align_prep`` and the detector's R-Net
    and O-Net crops launch on CUDA tensors.
  Stage B: the remaining rotation as two shears (y, then x) of the bf16
    patch, each a coarse one-hot translate at granularity 8 and a 9-tap fine
    pass (``_shear``). ``rotate_patches`` is the plain version of the CUDA
    kernel ``csrc/shear_rotate.cu`` (``ops/warp_kernel.py``), which
    ``align_and_crop_fast_batched`` launches on CUDA tensors.

Images are NHWC; coordinates are (x, y) pixels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

COARSE = 8  # two-level shear granularity


def _bilinear_weights(starts: torch.Tensor, scales: torch.Tensor, out_size: int,
                      in_size: int) -> torch.Tensor:
    """[..., out, in] matrices: row p samples input at starts + scales*p
    (edge-clamped bilinear)."""
    p = torch.arange(out_size, dtype=torch.float32, device=starts.device)
    pos = starts[..., None] + scales[..., None] * p
    pos = pos.clamp(0.0, in_size - 1.0)
    s = torch.arange(in_size, dtype=torch.float32, device=starts.device)
    return torch.clamp(1.0 - (pos[..., None] - s).abs(), min=0.0)


def _bf16_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def crop_resize_matmul_batched(images: torch.Tensor, boxes: torch.Tensor, out_size: int,
                               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per frame, N axis-aligned crops: images [B, H, W, C], boxes [B, N, 4]
    -> [B, N, out, out, C], resampled with matmuls only."""
    b, h, w, c = images.shape
    n = boxes.shape[1]
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    sy = torch.clamp(y2 - y1, min=1.0) / out_size
    sx = torch.clamp(x2 - x1, min=1.0) / out_size
    wy = _bf16_f32(_bilinear_weights(y1, sy, out_size, h))  # [B, N, P, H]
    wx = _bf16_f32(_bilinear_weights(x1, sx, out_size, w))  # [B, N, Q, W]
    img = _bf16_f32(images).reshape(b, 1, h, w * c)
    t = _bf16_f32(torch.matmul(wy, img))  # [B, N, P, W*C], f32 then rounded
    t = t.reshape(b * n, out_size, w, c).permute(0, 2, 1, 3).reshape(b * n, w, out_size * c)
    out = torch.bmm(wx.reshape(b * n, out_size, w), t)  # [B*N, Q, P*C]
    out = out.reshape(b, n, out_size, out_size, c).permute(0, 1, 3, 2, 4)
    return out.to(out_dtype).contiguous()


def crop_resize_matmul(image: torch.Tensor, boxes: torch.Tensor, out_size: int,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N crops from ONE image [H, W, C], boxes [N, 4] -> [N, out, out, C]."""
    return crop_resize_matmul_batched(image[None], boxes[None], out_size, out_dtype)[0]


def _shear_lines(slope: torch.Tensor, const: torch.Tensor, p: int, k_lo: int, k_hi: int):
    """Per-line shift split for one shear pass, in f32: coarse slot ``c``,
    fine base ``fb`` and fraction ``ff``; line l moves by 8*c + fb + ff."""
    other = torch.arange(p, dtype=torch.float32, device=slope.device) - (p - 1) / 2.0
    shift = slope[:, None] * other[None, :] + const[:, None]  # [N, P]
    shift = shift.clamp(k_lo, k_hi - 1.0)
    base = torch.floor(shift)
    frac = shift - base
    c = torch.floor(base / COARSE)
    r = base - c * COARSE
    f = r + frac
    fb = torch.floor(f)
    return c, fb, f - fb


def _shear(patch: torch.Tensor, slope: torch.Tensor, const: torch.Tensor, k_lo: int,
           k_hi: int, axis: int) -> torch.Tensor:
    """Shear along ``axis`` (2 = x, shift varies per row; 1 = y, shift varies
    per column) as sums of static slices of the zero-padded patch, in the
    patch dtype: a one-hot coarse translate, then the 9-tap fine pass."""
    p = patch.shape[1]
    dt = patch.dtype
    c, fb, ff = _shear_lines(slope, const, p, k_lo, k_hi)
    c_lo = math.floor(k_lo / COARSE)
    c_hi = math.floor((k_hi - 1) / COARSE)
    pad_lo = max(-c_lo * COARSE, 0)
    pad_hi = max(c_hi * COARSE + COARSE + 1, 0)
    pads = (0, 0, pad_lo, pad_hi) if axis == 2 else (0, 0, 0, 0, pad_lo, pad_hi)
    padded = F.pad(patch, pads)
    expand = (slice(None), slice(None), None, None) if axis == 2 else (
        slice(None), None, slice(None), None)
    width1 = p + COARSE + 1
    shape1 = list(patch.shape)
    shape1[axis] = width1
    out1 = torch.zeros(shape1, dtype=dt, device=patch.device)
    for ci in range(c_lo, c_hi + 1):
        m = (c == ci).to(dt)
        out1 = out1 + m[expand] * padded.narrow(axis, ci * COARSE + pad_lo, width1)
    out = torch.zeros_like(patch)
    for k in range(COARSE + 1):
        wk = (torch.where(fb == k, 1.0 - ff, 0.0) + torch.where(fb == k - 1, ff, 0.0)).to(dt)
        out = out + wk[expand] * out1.narrow(axis, k, p)
    return out


def _shear_params(phi: torch.Tensor, centers: torch.Tensor, p: int, max_rad: float):
    """Slopes, consts and static windows of the 2-shear remainder of the LDU
    rotation R = Diag(c, 1/c) . ShY(s*c) . ShX(-s/c); the diagonal folds into
    stage A (``_align_prep``)."""
    cosp, sinp = torch.cos(phi), torch.sin(phi)
    cp = (p - 1) / 2.0
    cap = 0.1 * p
    rcx = torch.clamp(centers[:, 0] - cp, -cap, cap)
    rcy = torch.clamp(centers[:, 1] - cp, -cap, cap)
    tx = (1 - cosp) * rcx + sinp * rcy
    ty = -sinp * rcx + (1 - cosp) * rcy
    slope_y = sinp * cosp
    slope_x = -sinp / cosp
    const_y = cosp * ty - sinp * tx
    const_x = tx / cosp
    cmin = math.cos(max_rad)
    smax = math.sin(max_rad)
    tmax = (smax + (1 - cmin)) * cap
    ky = int(math.ceil(smax * cmin * p / 2 + (1.0 + smax) * tmax)) + 1
    kx = int(math.ceil((smax / cmin) * (p / 2) + tmax / cmin)) + 1
    return slope_y, const_y, slope_x, const_x, ky, kx


def rotate_patches(patches: torch.Tensor, angles: torch.Tensor, centers: torch.Tensor,
                   out_size: int, max_angle_deg: float = 15.0) -> torch.Tensor:
    """Plain version of the rotation kernel: finish the rotation of
    D-prescaled patches [N, P, P, C] with the y then x shear in bf16, then
    centre-crop to ``out_size``."""
    p = patches.shape[1]
    max_rad = math.radians(max_angle_deg)
    phi = torch.clamp(angles.float(), -max_rad, max_rad)
    sy, cy, sx, cx, ky, kx = _shear_params(phi, centers.float(), p, max_rad)
    out = patches.to(torch.bfloat16)
    out = _shear(out, sy, cy, -ky, ky, axis=1)
    out = _shear(out, sx, cx, -kx, kx, axis=2)
    off = (p - out_size) // 2
    return out[:, off:off + out_size, off:off + out_size, :].to(patches.dtype)


def _align_prep(frames: torch.Tensor, boxes: torch.Tensor, landmarks: torch.Tensor,
                out_size: int, pad: float, max_angle_deg: float = 15.0):
    """Stage A for frames [B, H, W, C], boxes [B, F, 4], landmarks
    [B, F, 5, 2]: bf16 patches [B, F, P, P, C], eye angles [B, F] and
    rotation centres in patch coordinates [B, F, 2]."""
    from facerec_torch.ops.crop_kernel import crop_resize_kernel

    x1, y1, x2, y2 = boxes.float().unbind(-1)
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)
    p_size = int(round(out_size * (1 + 2 * pad) / 8)) * 8
    extra = (p_size - out_size) / (2.0 * out_size)
    bx0, by0 = x1 - extra * bw, y1 - extra * bh
    bx2, by2 = x2 + extra * bw, y2 + extra * bh

    lm = landmarks.float()
    le, re = lm[..., 0, :], lm[..., 1, :]
    angle = torch.atan2(re[..., 1] - le[..., 1], re[..., 0] - le[..., 0])
    ex = ((le[..., 0] + re[..., 0]) / 2 - bx0) / (bx2 - bx0) * p_size
    ey = ((le[..., 1] + re[..., 1]) / 2 - by0) / (by2 - by0) * p_size
    centers = torch.stack([ex, ey], dim=-1)

    # fold Diag(c, 1/c) about the patch centre into the box
    max_rad = math.radians(max_angle_deg)
    cosp = torch.cos(torch.clamp(angle, -max_rad, max_rad))
    cp = (p_size - 1) / 2.0
    sx = (bx2 - bx0) / p_size
    sy = (by2 - by0) / p_size
    dx1 = bx0 + sx * cp * (1.0 - cosp)
    dy1 = by0 + sy * cp * (1.0 - 1.0 / cosp)
    big_d = torch.stack([dx1, dy1, dx1 + cosp * (bx2 - bx0), dy1 + (by2 - by0) / cosp], dim=-1)
    patches = crop_resize_kernel(frames, big_d, p_size, out_dtype=torch.bfloat16)
    return patches, angle, centers


def align_and_crop_fast_batched(frames: torch.Tensor, boxes: torch.Tensor,
                                landmarks: torch.Tensor, out_size: int, pad: float = 0.15,
                                max_angle_deg: float = 15.0,
                                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Whole-batch align: per-frame crop matmuls, then one rotation over all
    B*F patches (the CUDA kernel on CUDA tensors). -> [B, F, out, out, C]."""
    from facerec_torch.ops.warp_kernel import rotate_patches_kernel

    b, f = boxes.shape[0], boxes.shape[1]
    patches, angle, centers = _align_prep(frames, boxes, landmarks, out_size, pad,
                                          max_angle_deg)
    p_size, ch = patches.shape[2], patches.shape[-1]
    flat = patches.reshape(b * f, p_size, p_size, ch)
    rot = rotate_patches_kernel(flat, angle.reshape(-1), centers.reshape(-1, 2), out_size,
                                max_angle_deg)
    return rot.reshape(b, f, out_size, out_size, ch).to(out_dtype)
