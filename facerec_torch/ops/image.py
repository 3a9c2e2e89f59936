"""Image geometry on NHWC tensors (counterpart of ``facerec_tpu/ops/image.py``:
``resize_bilinear`` and ``bbox_with_margin``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
