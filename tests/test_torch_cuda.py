"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and ``nvcc``; without them they skip. On the
card: ``python -m pytest tests/test_torch_cuda.py -m cuda``."""

import math

import pytest
import torch

from facerec_torch.ops.gallery import (bf16_rows_per_split, bf16_splits, gallery_topk,
                                       gallery_topk_plain)
from facerec_torch.ops.warp_fast import rotate_patches
from facerec_torch.ops.warp_kernel import rotate_patches_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _unit(g0, rows, dim, dev):
    x = torch.randn(rows, dim, generator=g0, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def _assert_kernel_agrees(q, g, count, k, tol):
    """The kernel against the plain version fed the queries as the kernel
    rounds them (to the gallery dtype): indices exact except where the plain
    scores of the two rows lie within 1e-5 (summation order), at most 0.1%
    of the slots; values within 1e-5; and within ``tol`` of the plain
    version with f32 queries."""
    cnt = torch.tensor(count, dtype=torch.int32, device=q.device)
    before = gallery_topk.launches
    v1, i1 = gallery_topk(q, g, cnt, k=k)
    v0, i0 = gallery_topk_plain(q.to(g.dtype), g, cnt, k=k)
    vf, _ = gallery_topk_plain(q, g, cnt, k=k)
    torch.cuda.synchronize()
    assert gallery_topk.launches == before + 1
    nv = min(count, k)
    assert torch.equal(i1[:, nv:], i0[:, nv:]) and torch.equal(v1[:, nv:], v0[:, nv:])
    differ = i1[:, :nv] != i0[:, :nv]
    if differ.any():
        qr = q.to(g.dtype).float()
        s1 = (qr[:, None, :] * g[i1[:, :nv].long()].float()).sum(-1)
        assert (s1 - v0[:, :nv]).abs()[differ].max().item() <= 1e-5
    assert differ.sum().item() <= 1e-3 * max(differ.numel(), 1) or differ.sum().item() <= 1
    if nv:
        assert (v1 - v0)[:, :nv].abs().max().item() <= 1e-5
        assert (v1 - vf)[:, :nv].abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-3), (torch.float32, 1e-4)])
@pytest.mark.parametrize("rows,count", [(1024, 700), (1024, 3), (1024, 0), (5000, 4999)])
def test_gallery_topk_kernel_matches_plain(dev, dtype, tol, rows, count):
    g0 = torch.Generator(device=dev).manual_seed(rows + count)
    q = _unit(g0, 37, 256, dev)  # unit queries, as the embedder gives them
    g = _unit(g0, rows, 256, dev).to(dtype)
    _assert_kernel_agrees(q, g, count, 5, tol)


@pytest.mark.parametrize("k", [1, 5, 32])
@pytest.mark.parametrize("b,count", [(37, 127), (37, 128), (37, 129), (37, 257),
                                     (37, 132 * 128 - 1), (37, 132 * 128), (37, 132 * 128 + 1),
                                     (384, 44 * 128), (384, 44 * 128 + 1), (300, 20000)])
def test_gallery_topk_kernel_tile_and_split_edges(dev, k, b, count):
    """Counts at the edges of the bf16 kernel's 128-row tiles and of its
    splits (132 splits at 37 queries, 44 at 384), k from 1 to 32."""
    g0 = torch.Generator(device=dev).manual_seed(count + k)
    q = _unit(g0, b, 512, dev)
    g = _unit(g0, 20000, 512, dev).to(torch.bfloat16)
    _assert_kernel_agrees(q, g, count, k, 2e-3)


@pytest.mark.parametrize("dim", [16, 80, 576])
def test_gallery_topk_kernel_ragged_depth(dev, dim):
    """Widths that are multiples of 16 but not of the kernel's 64-deep
    stages (the tail is zero-filled), and one wider than 512."""
    g0 = torch.Generator(device=dev).manual_seed(dim)
    q = _unit(g0, 130, dim, dev)
    g = _unit(g0, 3000, dim, dev).to(torch.bfloat16)
    _assert_kernel_agrees(q, g, 2999, 5, 2e-3)


def test_gallery_topk_kernel_refuses_width(dev):
    g = torch.zeros(256, 40, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        gallery_topk(torch.zeros(3, 40, device=dev), g, 10)


def test_gallery_topk_kernel_split_boundary_ties(dev):
    """Identical rows on both sides of a split boundary and of a tile
    boundary score exactly alike; the lower row must come first."""
    g0 = torch.Generator(device=dev).manual_seed(7)
    rows, count, b = 131072, 100003, 384
    g = _unit(g0, rows, 512, dev).to(torch.bfloat16)
    q = _unit(g0, b, 512, dev)
    per = bf16_rows_per_split(count, bf16_splits(b, rows))
    pairs = [(per - 1, per), (3 * per - 1, 3 * per), (127, 128)]
    for n, (lo, hi) in enumerate(pairs):
        g[hi] = g[lo]
        q[n] = g[lo].float()
    _assert_kernel_agrees(q, g, count, 5, 2e-3)
    _, i1 = gallery_topk(q, g, torch.tensor(count, dtype=torch.int32, device=dev), k=5)
    for n, (lo, hi) in enumerate(pairs):
        assert i1[n, :2].tolist() == [lo, hi]


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
