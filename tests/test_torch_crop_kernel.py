"""The crop kernel's arithmetic on the CPU: ``crop_taps`` and a two-tap
gather built from it against ``warp_fast.crop_resize_matmul_batched`` (the
matmul route that ``csrc/crop_resize.cu`` repeats bit for bit), at the
shapes of the serve step's three calls, and the wrapper's CPU route. The
kernel itself runs in ``tests/test_torch_cuda.py``."""

import zlib

import numpy as np
import pytest
import torch

from facerec_torch.ops import kernels
from facerec_torch.ops.crop_kernel import crop_resize_kernel, crop_taps
from facerec_torch.ops.warp_fast import _bf16_f32, _bilinear_weights, crop_resize_matmul_batched

# (name, source H x W, source dtype, out): R-Net, O-Net and align stage A
SITES = [("rnet", (288, 384), torch.float32, 24), ("onet", (480, 640), torch.bfloat16, 48),
         ("align", (480, 640), torch.float32, 208)]
KINDS = ("inside", "straddling", "outside", "subpixel", "integer", "nonfinite")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _frames(hw, dtype, integer, rng, b=2):
    if integer:  # 0..255 pixels, as the align stage reads them
        x = rng.integers(0, 256, (b, *hw, 3)).astype(np.float32)
    else:  # the detector's normalised range
        x = rng.uniform(-1.0, 1.0, (b, *hw, 3)).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _boxes(kind, hw, out, rng, b=2, n=3):
    """[b, n, 4] boxes of one kind for an H x W frame."""
    h, w = hw
    if kind == "integer":  # every position an integer: integer starts, scale 1 or 2
        x1 = rng.integers(0, w // 2, (b, n)).astype(np.float32)
        y1 = rng.integers(0, h // 2, (b, n)).astype(np.float32)
        k = rng.integers(1, 3, (b, n)).astype(np.float32)
        return torch.from_numpy(np.stack([x1, y1, x1 + k * out, y1 + k * out], -1))
    if kind == "subpixel":  # sides under a pixel, which the route clamps to 1
        x1 = rng.uniform(0, w - 1, (b, n))
        y1 = rng.uniform(0, h - 1, (b, n))
        d = rng.uniform(0.0, 0.9, (b, n, 2))
        return torch.from_numpy(np.stack([x1, y1, x1 + d[..., 0], y1 + d[..., 1]], -1)
                                .astype(np.float32))
    side = rng.uniform(0.15, 0.6, (b, n)) * min(h, w)
    if kind == "inside":
        x1 = rng.uniform(0, w - side)
        y1 = rng.uniform(0, h - side)
    elif kind == "straddling":  # across the left/top or the right/bottom edge
        lo = rng.random((b, n)) < 0.5
        x1 = np.where(lo, -side / 2, w - side / 2) + rng.uniform(-3, 3, (b, n))
        y1 = np.where(lo, h - side / 2, -side / 2) + rng.uniform(-3, 3, (b, n))
    elif kind == "outside":  # wholly beyond an edge of the frame
        x1 = np.where(rng.random((b, n)) < 0.5, -side - 5.0, w + 5.0)
        y1 = rng.uniform(-side - 20.0, h + 20.0)
    else:  # nonfinite: a NaN start, an infinite end, an infinite start
        x1 = rng.uniform(0, w - side)
        y1 = rng.uniform(0, h - side)
    bx = np.stack([x1, y1, x1 + side, y1 + side], -1).astype(np.float32)
    if kind == "nonfinite":
        bx[0, 0, 0] = np.nan
        bx[0, 1, 3] = np.inf
        bx[1, 2, 1] = -np.inf
    return torch.from_numpy(bx)


def crop_case(site, kind):
    """(images, boxes, out) of one site and one kind of box, from a seed of
    their names."""
    name, hw, dtype, out = site
    rng = np.random.default_rng(zlib.crc32(f"{name}:{kind}".encode()))
    return _frames(hw, dtype, name == "align", rng), _boxes(kind, hw, out, rng), out


def _two_tap(images, boxes, out):
    """The kernel's arithmetic in PyTorch: each axis's two taps from
    ``crop_taps``, the source and the row pass rounded to bf16."""
    b, h, w, c = images.shape
    n = boxes.shape[1]
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    iy, wy = crop_taps(y1, torch.clamp(y2 - y1, min=1.0) / out, out, h)  # [B, N, P, 2]
    ix, wx = crop_taps(x1, torch.clamp(x2 - x1, min=1.0) / out, out, w)
    src = _bf16_f32(images)
    frame = torch.arange(b)[:, None, None]
    wy, wx = wy.float(), wx.float()
    t = (wy[..., 0, None, None] * src[frame, iy[..., 0]]
         + wy[..., 1, None, None] * src[frame, iy[..., 1]])  # [B, N, P, W, C]
    t = _bf16_f32(t)
    cols = [torch.gather(t, 3, ix[..., k][:, :, None, :, None].expand(b, n, out, out, c))
            for k in (0, 1)]
    return wx[..., 0][:, :, None, :, None] * cols[0] + wx[..., 1][:, :, None, :, None] * cols[1]


def _same(a, b) -> bool:
    """Equal values, NaN where the other has NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("site", SITES, ids=[s[0] for s in SITES])
def test_two_tap_gather_matches_matmul_route(site, kind):
    """``crop_taps`` holds the nonzeros of the matmul route's bf16 weight
    rows, and the two-tap gather equals the route bit for bit."""
    images, boxes, out = crop_case(site, kind)
    hw = images.shape[1:3]
    ref = crop_resize_matmul_batched(images, boxes, out)
    got = _two_tap(images, boxes, out)
    assert got.shape == ref.shape == (2, 3, out, out, 3)
    assert _same(got, ref)
    assert torch.isnan(ref).any() == (kind == "nonfinite")

    # the taps against the dense weight rows, one axis
    x1, x2 = boxes[..., 0], boxes[..., 2]
    scale = torch.clamp(x2 - x1, min=1.0) / out
    dense = _bf16_f32(_bilinear_weights(x1, scale, out, hw[1]))  # [B, N, out, W]
    idx, w = crop_taps(x1, scale, out, hw[1])
    sparse = torch.zeros_like(dense).scatter_add_(-1, idx, w.float())
    rows = ~torch.isnan(dense).any(-1)
    assert torch.equal(sparse[rows], dense[rows])
    assert torch.isnan(w[~rows]).all() and not torch.isnan(w[rows]).any()
    assert ((dense[rows] != 0).sum(-1) <= 2).all()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_is_the_matmul_route(out_dtype):
    rng = np.random.default_rng(1)
    images = _frames((60, 80), torch.float32, False, rng)
    boxes = _boxes("inside", (60, 80), 24, rng)
    before = kernels.launches()
    got = crop_resize_kernel(images, boxes, 24, out_dtype)
    assert kernels.launches() == before
    assert got.dtype == out_dtype
    assert torch.equal(got, crop_resize_matmul_batched(images, boxes, 24, out_dtype))


@pytest.mark.parametrize("b,n", [(2, 0), (0, 3)])
def test_wrapper_empty_batch(b, n):
    images = torch.zeros(b, 30, 40, 3)
    got = crop_resize_kernel(images, torch.zeros(b, n, 4), 16, torch.bfloat16)
    assert got.shape == (b, n, 16, 16, 3) and got.dtype == torch.bfloat16
