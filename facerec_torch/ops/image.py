"""Image geometry on NHWC tensors (counterpart of ``facerec_tpu/ops/image.py``):
the exact gather warp behind ``FacePipeline(precise_align=True)``, the plain
resize of the detector's pyramid, and ``bbox_with_margin``.

The warp composes ONE output->input affine per face (eye-levelling rotation,
crop and resize) and samples the source once, bilinearly. Conventions, as
JAX's: images are NHWC float; points are (x, y) pixel positions, as
OpenCV's; a 2x3 affine maps OUTPUT coordinates to INPUT coordinates (the
sampling form). Samples outside the frame are zero, with the indices
clamped before the gather, JAX's edge rule; ``grid_sample`` pads and places
corners differently, so the gathers are explicit.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def _sample(images: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``images`` [B, H, W, C] at float coordinates
    x, y [B, ...] -> [B, ..., C]; zero outside the frame."""
    b, h, w = images.shape[:3]
    bi = torch.arange(b, device=images.device).view(b, *([1] * (x.dim() - 1)))
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = images[bi, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(valid[..., None], vals, 0.0)

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    top = v00 * (1 - dx) + v01 * dx
    bot = v10 * (1 - dx) + v11 * dx
    return top * (1 - dy) + bot * dy


def bilinear_sample(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample ``image`` [H, W, C] at float coordinates x, y (one shape,
    e.g. [h, w]) with bilinear interpolation and zero padding outside."""
    return _sample(image[None], x[None], y[None])[0]


def _warp(images: torch.Tensor, matrices: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """images [B, H, W, C], sampling maps [B, N, 2, 3] -> [B, N, oh, ow, C]."""
    oh, ow = out_hw
    ys = torch.arange(oh, dtype=torch.float32, device=images.device)[:, None].expand(oh, ow)
    xs = torch.arange(ow, dtype=torch.float32, device=images.device)[None, :].expand(oh, ow)
    m = matrices.float()[..., None, None]  # [B, N, 2, 3, 1, 1]
    src_x = m[:, :, 0, 0] * xs + m[:, :, 0, 1] * ys + m[:, :, 0, 2]
    src_y = m[:, :, 1, 0] * xs + m[:, :, 1, 1] * ys + m[:, :, 1, 2]
    return _sample(images, src_x, src_y)


def affine_warp(images: torch.Tensor, matrices: torch.Tensor, out_hw: tuple[int, int]
                ) -> torch.Tensor:
    """Batched warp: images [B, H, W, C], matrices [B, 2, 3] (output->input)
    -> [B, oh, ow, C]."""
    return _warp(images, matrices[:, None], out_hw)[:, 0]


def rotation_matrix(center_xy: torch.Tensor, angle_deg: torch.Tensor | float,
                    scale: torch.Tensor | float = 1.0) -> torch.Tensor:
    """``cv2.getRotationMatrix2D`` semantics (the forward map); [..., 2, 3]."""
    dev = center_xy.device
    # a Python angle is filled on the device: a host copy could not be captured
    a = torch.deg2rad(torch.as_tensor(angle_deg, dtype=torch.float32, device=dev)
                      if isinstance(angle_deg, torch.Tensor)
                      else torch.full((), angle_deg, dtype=torch.float32, device=dev))
    alpha = torch.cos(a) * scale
    beta = torch.sin(a) * scale
    alpha, beta, cx, cy = torch.broadcast_tensors(alpha, beta, center_xy[..., 0],
                                                  center_xy[..., 1])
    row0 = torch.stack([alpha, beta, (1 - alpha) * cx - beta * cy], dim=-1)
    row1 = torch.stack([-beta, alpha, beta * cx + (1 - alpha) * cy], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Invert a [..., 2, 3] affine (forward map -> sampling map)."""
    a, b, tx = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    c, d, ty = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    row0 = torch.stack([ia, ib, itx], dim=-1)
    row1 = torch.stack([ic, id_, ity], dim=-1)
    return torch.stack([row0, row1], dim=-2)


@functools.lru_cache(maxsize=None)
def _affine_last_row(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[[0, 0, 1]], built once per dtype and device (a host-to-device copy
    inside the serve step would stop it from being captured)."""
    return torch.tensor([[0.0, 0.0, 1.0]], dtype=dtype, device=device)


def compose_affine(m2: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """Compose sampling maps: result(p) = m1(m2(p)) for output coordinates
    p (m2 first, when both are output->input maps of successive stages)."""
    last = _affine_last_row(m1.dtype, m1.device)
    a = torch.cat([m1, last.expand(*m1.shape[:-2], 1, 3)], dim=-2)
    b = torch.cat([m2, last.expand(*m2.shape[:-2], 1, 3)], dim=-2)
    return (a @ b)[..., :2, :]


def _crop_matrix(boxes: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Crop + resize sampling map per x1y1x2y2 box [..., 4] -> [..., 2, 3]."""
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)
    zeros = torch.zeros_like(bw)
    return torch.stack([
        torch.stack([bw / out_hw[1], zeros, x1], dim=-1),
        torch.stack([zeros, bh / out_hw[0], y1], dim=-1),
    ], dim=-2)


def align_crop_matrix(boxes: torch.Tensor, landmarks: torch.Tensor | None,
                      out_size: int) -> torch.Tensor:
    """ONE output->input affine per face [..., 2, 3]: eye-levelling rotation
    about the eyes' midpoint (angle from the eye landmarks, rows 0 and 1 of
    landmarks [..., 5, 2]) fused with crop + resize of boxes [..., 4]."""
    crop = _crop_matrix(boxes, (out_size, out_size))
    if landmarks is None:
        return crop
    lm = landmarks.float()
    le, re = lm[..., 0, :], lm[..., 1, :]
    angle = torch.rad2deg(torch.atan2(re[..., 1] - le[..., 1], re[..., 0] - le[..., 0]))
    center = (le + re) / 2.0
    rot_inv = invert_affine(rotation_matrix(center, angle))
    # out pixel -> rotated-image pixel -> source pixel
    return compose_affine(crop, rot_inv)


def align_and_crop(images: torch.Tensor, boxes: torch.Tensor,
                   landmarks: torch.Tensor | None, out_size: int) -> torch.Tensor:
    """Fused align + crop + resize, one face per image: [B, H, W, C], boxes
    [B, 4], landmarks [B, 5, 2] -> [B, out, out, C]."""
    return affine_warp(images, align_crop_matrix(boxes, landmarks, out_size),
                       (out_size, out_size))


def crop_and_resize(images: torch.Tensor, boxes: torch.Tensor, out_hw: tuple[int, int]
                    ) -> torch.Tensor:
    """One box per image: [B, H, W, C], boxes [B, 4] -> [B, oh, ow, C]."""
    return affine_warp(images, _crop_matrix(boxes, out_hw), out_hw)


def align_and_crop_batched(frames: torch.Tensor, boxes: torch.Tensor, landmarks: torch.Tensor,
                           out_size: int) -> torch.Tensor:
    """``align_and_crop_from`` over a frame batch in one gather: frames
    [B, H, W, C], boxes [B, F, 4], landmarks [B, F, 5, 2] -> [B, F, out,
    out, C]."""
    return _warp(frames, align_crop_matrix(boxes, landmarks, out_size), (out_size, out_size))


def align_and_crop_from(image: torch.Tensor, boxes: torch.Tensor, landmarks: torch.Tensor,
                        out_size: int) -> torch.Tensor:
    """N aligned crops out of ONE image [H, W, C] -> [N, out, out, C]; the
    gathers index the shared image (no per-box copies)."""
    return align_and_crop_batched(image[None], boxes[None], landmarks[None], out_size)[0]


def crop_and_resize_from(image: torch.Tensor, boxes: torch.Tensor, out_hw: tuple[int, int]
                         ) -> torch.Tensor:
    """N boxes out of ONE image [H, W, C] -> [N, oh, ow, C]."""
    return _warp(image[None], _crop_matrix(boxes, out_hw)[None], out_hw)[0]


def resize_bilinear(images: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Batched bilinear resize [B, H, W, C] -> [B, oh, ow, C]. Antialiased
    when downsampling, as ``jax.image.resize(..., "bilinear")`` is: with
    ``antialias=False`` the pyramid levels differ by up to ~1 unit. Computes
    in f32 (PyTorch's antialiased resize takes no bf16 on the CPU) and
    returns the input dtype; callers that resize one tensor many times pass
    it in f32."""
    x = images.permute(0, 3, 1, 2).float()  # NCHW view in channels_last memory
    y = F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.permute(0, 2, 3, 1).to(images.dtype).contiguous()


def bbox_with_margin(boxes: torch.Tensor, margin: float, img_hw: tuple[int, int]
                     ) -> torch.Tensor:
    """Expand x1y1x2y2 boxes by a relative margin, clipped to the image
    (reference get_face_bbox_with_margin data_prep.py:89-106)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    mw = (x2 - x1) * margin / 2
    mh = (y2 - y1) * margin / 2
    h, w = img_hw
    return torch.stack([
        torch.clamp(x1 - mw, 0, w - 1),
        torch.clamp(y1 - mh, 0, h - 1),
        torch.clamp(x2 + mw, 0, w - 1),
        torch.clamp(y2 + mh, 0, h - 1),
    ], dim=-1)
