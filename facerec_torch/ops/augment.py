"""Random augmentations (counterpart of ``facerec_tpu/ops/augment.py``;
reference data_prep.py:38-48, 155-170: rotate +-20 degrees, brightness and
contrast +-0.2, scale +-0.1, horizontal flip).

All geometry composes into ONE sampling affine per image (a single
resampling), as in JAX. The randomness is split from its use:
``draw_augment`` takes every per-image draw from an explicit CPU
``torch.Generator``, and ``apply_augment`` is deterministic given the draws,
on whatever device the images live. The draws are a few scalars per image,
so one seed gives the same augmented images on the card and on the CPU.
The stream is torch's, not JAX's threefry: the port's augmented images
differ from the JAX package's for a seed, while ``apply_augment`` fed JAX's
own draws reproduces ``augment_batch``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from facerec_torch.ops.image import affine_warp, compose_affine, invert_affine, rotation_matrix


class AugmentParams(NamedTuple):
    rotation_degrees: float = 20.0
    brightness: float = 0.2
    contrast: float = 0.2
    scale: float = 0.1
    horizontal_flip: bool = True
    p_geometry: float = 0.7  # albumentations' p in the reference
    p_flip: float = 0.5
    p_color: float = 0.7


class AugmentDraws(NamedTuple):
    """Per-image draws [B] (f32), in the order ``augment_batch`` takes them:
    the angle in degrees and the scale factor, then three uniform gates in
    [0, 1) compared against ``p_geometry``, ``p_flip`` and ``p_color``,
    then the brightness offset and the contrast factor."""

    angle: torch.Tensor
    scale: torch.Tensor
    geometry: torch.Tensor
    flip: torch.Tensor
    color: torch.Tensor
    brightness: torch.Tensor
    contrast: torch.Tensor

    def to(self, device: torch.device) -> "AugmentDraws":
        return AugmentDraws(*(t.to(device) for t in self))


def _uniform(generator: torch.Generator, b: int, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return torch.rand(b, generator=generator) * (hi - lo) + lo


def draw_augment(generator: torch.Generator, b: int, params: AugmentParams = AugmentParams()
                 ) -> AugmentDraws:
    """Every draw for ``b`` images from a CPU ``generator``. All seven are
    drawn whatever ``params`` switches off, so the stream does not depend
    on them."""
    return AugmentDraws(
        angle=_uniform(generator, b, -params.rotation_degrees, params.rotation_degrees),
        scale=1.0 + _uniform(generator, b, -params.scale, params.scale),
        geometry=_uniform(generator, b),
        flip=_uniform(generator, b),
        color=_uniform(generator, b),
        brightness=_uniform(generator, b, -params.brightness, params.brightness),
        contrast=1.0 + _uniform(generator, b, -params.contrast, params.contrast),
    )


def apply_augment(images: torch.Tensor, draws: AugmentDraws,
                  params: AugmentParams = AugmentParams()) -> torch.Tensor:
    """images [B, H, W, C] float in [0, 1] -> augmented, same shape, on the
    images' device: rotation and scale about the centre (where the geometry
    gate fires), a horizontal flip (where enabled and its gate fires), one
    bilinear resampling, then brightness and contrast about each image's
    mean (where the colour gate fires), clipped to [0, 1]."""
    b, h, w, _ = images.shape
    d = draws.to(images.device)
    do_geom = d.geometry < params.p_geometry
    angle = torch.where(do_geom, d.angle, 0.0)
    scale = torch.where(do_geom, d.scale, 1.0)
    center = torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0], device=images.device).expand(b, 2)
    m = invert_affine(rotation_matrix(center, angle, scale))  # out -> in sampling map
    if params.horizontal_flip:
        do_flip = (d.flip < params.p_flip).float()
        zeros, ones = torch.zeros(b, device=images.device), torch.ones(b, device=images.device)
        flip = torch.stack([
            torch.stack([1.0 - 2.0 * do_flip, zeros, do_flip * (w - 1)], dim=-1),
            torch.stack([zeros, ones, zeros], dim=-1),
        ], dim=-2)
        m = compose_affine(flip, m)
    out = affine_warp(images, m, (h, w))
    do_color = d.color < params.p_color
    bright = torch.where(do_color, d.brightness, 0.0)[:, None, None, None]
    contrast = torch.where(do_color, d.contrast, 1.0)[:, None, None, None]
    mean = out.mean(dim=(1, 2, 3), keepdim=True)
    out = (out - mean) * contrast + mean + bright
    return torch.clamp(out, 0.0, 1.0)


def augment_batch(images: torch.Tensor, params: AugmentParams,
                  generator: torch.Generator) -> torch.Tensor:
    """``apply_augment`` on draws from ``generator``, a CPU generator."""
    return apply_augment(images, draw_augment(generator, images.shape[0], params), params)


def low_data_variants(image: torch.Tensor, n: int, params: AugmentParams,
                      generator: torch.Generator) -> torch.Tensor:
    """N variants of one image [H, W, C] (reference low-data augmentation,
    data_prep.py:353-396: 5 variants when a class has fewer than 20 train
    images), geometry and colour always on."""
    batch = image[None].expand(n, *image.shape)
    strong = params._replace(p_geometry=1.0, p_color=1.0)
    return augment_batch(batch, strong, generator)
