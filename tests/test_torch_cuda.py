"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and ``nvcc``; without them they skip. On the
card: ``python -m pytest tests/test_torch_cuda.py -m cuda``."""

import math

import pytest
import torch

from facerec_torch.ops.gallery import gallery_topk, gallery_topk_plain
from facerec_torch.ops.warp_fast import rotate_patches
from facerec_torch.ops.warp_kernel import rotate_patches_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-3), (torch.float32, 1e-4)])
@pytest.mark.parametrize("rows,count", [(1024, 700), (1024, 3), (1024, 0), (5000, 4999)])
def test_gallery_topk_kernel_matches_plain(dev, dtype, tol, rows, count):
    g0 = torch.Generator(device=dev).manual_seed(rows + count)
    q = torch.randn(37, 256, generator=g0, device=dev)
    g = torch.randn(rows, 256, generator=g0, device=dev)
    g = (g / g.norm(dim=1, keepdim=True)).to(dtype)
    cnt = torch.tensor(count, dtype=torch.int32, device=dev)
    before = gallery_topk.launches
    v1, i1 = gallery_topk(q, g, cnt, k=5)
    v0, i0 = gallery_topk_plain(q, g, cnt, k=5)
    torch.cuda.synchronize()
    assert gallery_topk.launches == before + 1
    assert torch.equal(i1, i0)
    assert (v1 - v0).abs().max().item() <= tol


def test_rotate_kernel_matches_plain(dev):
    g0 = torch.Generator(device=dev).manual_seed(0)
    n, p, e = 12, 128, 96
    patches = (torch.rand(n, p, p, 3, generator=g0, device=dev) * 255).to(torch.bfloat16)
    angles = (torch.rand(n, generator=g0, device=dev) * 2 - 1) * math.radians(20.0)
    centers = p * (0.3 + 0.4 * torch.rand(n, 2, generator=g0, device=dev))
    before = rotate_patches_kernel.launches
    got = rotate_patches_kernel(patches, angles, centers, e).float()
    ref = rotate_patches(patches, angles, centers, e).float()
    torch.cuda.synchronize()
    assert rotate_patches_kernel.launches == before + 1
    err = (got - ref).abs()
    assert err.max().item() <= 1.0 and err.mean().item() < 1e-3
