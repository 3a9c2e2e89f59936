"""Collectives over a mesh axis (counterpart of ``facerec_tpu/parallel/collectives.py``).

Each takes the mesh and the axis name where the JAX wrappers take only the
axis name (JAX finds the mesh from the enclosing ``shard_map``), and each is
the identity on an axis of size 1. ``psum`` and ``all_gather`` pass
gradients (the sum of the ranks' gradients flows back to each input), as
the sync BatchNorm of the train step needs.

The exact cross-shard top-k is ``global_topk_merge``: an all-gather of each
shard's ``[..., k]`` candidates and ``merge_topk``, a stable descending sort
over the ``n * k`` candidates in shard-major order. That keeps
``jax.lax.top_k``'s rule among ties (the lowest flat position first), which
``torch.topk`` does not promise; the masked slots of empty or short shards
are such ties.
"""

from __future__ import annotations

import pickle

import torch
import torch.distributed as dist

from facerec_torch.parallel.mesh import Mesh


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` must go through host memory: gloo does not take CUDA
    tensors (on the H100 machine, PyTorch 2.11, a gloo broadcast of a CUDA
    tensor aborts the process in the transport's ``writev`` with "Bad
    address"), so on a gloo group, the backend of ranks that share a card,
    a CUDA tensor is copied to pinned host memory and back. NCCL takes it
    as it is."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _pinned(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``t`` (contiguous) over ``group`` (None: every rank)."""
    if _staged(t, group):
        host = _pinned(t)
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, group, src_index: int = 0) -> torch.Tensor:
    """In place: ``t`` (contiguous) of the group's ``src_index``-th rank on
    every rank."""
    src = dist.get_global_rank(group, src_index) if group is not None else src_index
    if _staged(t, group):
        host = _pinned(t)
        dist.broadcast(host, src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src, group=group)
    return t


def gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[n, *x.shape]: every rank's ``x`` over ``group`` of ``n`` ranks, in
    group order (no gradient)."""
    flat = x.reshape(-1).contiguous()  # gloo wants the output as the inputs concatenated
    staged = _staged(flat, group)
    src = _pinned(flat) if staged else flat
    out = torch.empty(n * flat.numel(), dtype=x.dtype, device=src.device, pin_memory=staged)
    dist.all_gather_into_tensor(out, src, group=group)
    return (out.to(x.device) if staged else out).view(n, *x.shape)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.group, ctx.index = group, index
        return gather(x, group, n)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.group)
        return g[ctx.index], None, None, None


def psum(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    group = mesh.group(axis)
    return x if group is None else _Sum.apply(x, group)


def pmean(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    return psum(x, mesh, axis) / mesh.size(axis)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = "model", dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` along a new dim ``dim`` (untiled) or concatenated
    along ``dim`` (tiled), in the axis's order."""
    group = mesh.group(axis)
    if group is None:
        return x if tiled else x.unsqueeze(dim)
    out = _Gather.apply(x, group, mesh.size(axis), mesh.index(axis))  # [n, *x.shape]
    if not tiled:
        return out.movedim(0, dim)
    out = out.movedim(0, dim)
    return out.reshape(*x.shape[:dim], -1, *x.shape[dim + 1:])


def ppermute_ring(x: torch.Tensor, mesh: Mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """Rank ``i`` of the axis sends ``x`` to rank ``(i + shift) % n``: each
    rank gets the ``x`` of rank ``(i - shift) % n``. Built on the
    all-gather: it serves row-sized payloads."""
    n = mesh.size(axis)
    if n == 1:
        return x
    return all_gather(x, mesh, axis, tiled=False)[(mesh.index(axis) - shift) % n]


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str = "data",
                   scatter_dimension: int = 0) -> torch.Tensor:
    """The sum over the axis, of which each rank keeps its own contiguous
    block along ``scatter_dimension`` (``psum_scatter(..., tiled=True)``)."""
    n = mesh.size(axis)
    if n == 1:
        return x
    return psum(x, mesh, axis).chunk(n, dim=scatter_dimension)[mesh.index(axis)]


def axis_index(mesh: Mesh, axis: str) -> int:
    return mesh.index(axis)


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if mesh.world_size == 1:
        return obj
    data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    size = torch.tensor([data.numel()], dtype=torch.int64, device=mesh.device)
    broadcast_(size, None)
    buf = torch.zeros(int(size.item()), dtype=torch.uint8, device=mesh.device)
    if mesh.is_primary:
        buf.copy_(data)
    broadcast_(buf, None)
    return pickle.loads(buf.cpu().numpy().tobytes())


def merge_topk(all_vals: torch.Tensor, all_idx: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge ``n`` shards' top-k ``all_vals [n, ..., k]`` (descending) and
    their local indices ``all_idx`` into the global top-k: (values, local
    indices, shard ids), each ``[..., k]``. Ties go to the lower flat
    position of the shard-major candidate list, as ``lax.top_k``'s do."""
    n = all_vals.shape[0]
    shard = torch.arange(n, dtype=torch.int32, device=all_vals.device)
    shard = shard.view(n, *([1] * (all_vals.ndim - 1))).expand(all_idx.shape)

    def _flat(a):  # [n, ..., k] -> [..., n * k]
        a = a.movedim(0, -2)
        return a.reshape(*a.shape[:-2], -1)

    flat_v, flat_i, flat_s = _flat(all_vals), _flat(all_idx), _flat(shard)
    v, pos = torch.sort(flat_v, dim=-1, descending=True, stable=True)
    pos = pos[..., :k]
    return v[..., :k], flat_i.gather(-1, pos), flat_s.gather(-1, pos)


def global_topk_merge(local_vals: torch.Tensor, local_idx: torch.Tensor, k: int, mesh: Mesh,
                      axis: str = "model") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each shard's top-k ``[..., k]`` (values descending, local indices) to
    the exact global top-k over the axis, the same on every rank of it:
    an all-gather of the ``[..., k]`` slabs (O(n k) traffic, not the
    gallery) and ``merge_topk``. Returns (values, local indices, shard
    ids)."""
    return merge_topk(all_gather(local_vals, mesh, axis, tiled=False),
                      all_gather(local_idx, mesh, axis, tiled=False), k)
