"""Process mesh and sharding helpers (counterpart of ``facerec_tpu/parallel/mesh.py``).

PyTorch runs one process (rank) per card, not one controller over many
devices, so the port's mesh is a layout of ranks over two named axes:

  * ``data``  — data parallelism: each data index holds a contiguous slice
    of every batch; gradients, metric sums and BatchNorm statistics are
    summed over the ranks of one ``data`` group;
  * ``model`` — the serve step's gallery rows: each model index holds one
    row range of the gallery, and the shards' top-k candidates are merged
    exactly (``collectives.global_topk_merge``).

Rank ``r`` of a ``(dp, mp)`` mesh sits at ``(r // mp, r % mp)``, the
row-major layout of JAX's ``np.asarray(devices).reshape(dp, mp)``. The
shape and the layout are computed without a process group, so tests can
check them; the sub-groups exist only once ``torch.distributed`` is
initialised (``initialize_distributed``). Parameters are replicated:
``shard_params`` broadcasts them from rank 0 so every rank starts equal.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import os
from typing import Any, Iterator

import numpy as np
import torch
import torch.distributed as dist

from facerec_torch import resolve_device
from facerec_torch.config import MeshConfig


def default_backend(device: str | torch.device | None = None) -> str:
    """``nccl`` for a CUDA mesh, ``gloo`` for ``device="cpu"``. NCCL refuses
    two ranks on one card: ranks that share a card pass ``backend="gloo"``."""
    return "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: str | torch.device | None = None,
) -> bool:
    """Env-gated bootstrap of ``torch.distributed``. Reads
    ``FACEREC_COORDINATOR`` (``host:port``), ``FACEREC_NUM_PROCESSES`` and
    ``FACEREC_PROCESS_ID`` where the arguments are not given. With no
    coordinator it does nothing and returns False (one process).
    ``FACEREC_COORDINATOR=auto`` defers to ``env://``, the variables that
    ``torchrun`` sets; ``host:port`` becomes ``tcp://host:port``. The
    backend is ``backend``, else ``default_backend(device)``. With NCCL on a
    machine with cards, the rank's card (``cuda:{LOCAL_RANK}``, else the
    rank's) becomes the current one and is bound to the group
    (``device_id``), so that NCCL creates its communicators now, and those
    of ``build_mesh``'s sub-groups when they are made, never first inside a
    CUDA graph capture. Returns True once the process group is up."""
    addr = coordinator_address or os.environ.get("FACEREC_COORDINATOR")
    if not addr:
        return False
    kwargs: dict[str, Any] = {"backend": backend or default_backend(device)}
    p = process_id if process_id is not None else os.environ.get("FACEREC_PROCESS_ID")
    if addr == "auto":
        kwargs["init_method"] = "env://"
        p = os.environ.get("RANK")
    else:
        kwargs["init_method"] = addr if "://" in addr else f"tcp://{addr}"
        n = num_processes if num_processes is not None else os.environ.get("FACEREC_NUM_PROCESSES")
        if n is not None:
            kwargs["world_size"] = int(n)
        if p is not None:
            kwargs["rank"] = int(p)
    if kwargs["backend"] == "nccl" and torch.cuda.is_available():
        card = _local_card(int(p or 0))
        torch.cuda.set_device(card)
        kwargs["device_id"] = card
    dist.init_process_group(**kwargs)
    return True


def _local_card(rank: int) -> torch.device:
    """``cuda:{LOCAL_RANK % device_count}``, the rank standing in for
    ``LOCAL_RANK`` where no launcher set it."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` layout of ranks. ``shape`` maps each axis name to
    its size; ``groups`` maps it to the ``torch.distributed`` group of the
    ranks that share this rank's other coordinate (None where the axis has
    size 1, or where no process group exists: a layout-only mesh)."""

    shape: dict[str, int]
    rank: int
    device: torch.device
    groups: dict[str, Any]
    data_axis: str = "data"
    model_axis: str = "model"

    @property
    def world_size(self) -> int:
        return self.shape[self.data_axis] * self.shape[self.model_axis]

    @property
    def coords(self) -> tuple[int, int]:
        """This rank's (data index, model index)."""
        mp = self.shape[self.model_axis]
        return self.rank // mp, self.rank % mp

    @property
    def is_primary(self) -> bool:
        """Rank 0: the one rank that writes files and logs."""
        return self.rank == 0

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[0 if axis == self.data_axis else 1]

    def group(self, axis: str):
        """The process group over ``axis`` (None at size 1); raises for a
        layout-only mesh, whose collectives cannot run."""
        if self.shape[axis] == 1:
            return None
        if self.groups[axis] is None:
            raise RuntimeError(f"the {axis} axis has {self.shape[axis]} ranks but this mesh has "
                               "no process group (initialize_distributed first)")
        return self.groups[axis]

    def barrier(self) -> None:
        """Wait for every rank (a no-op on one rank)."""
        if self.world_size > 1:
            dist.barrier()


def _device(device, rank: int, world: int) -> torch.device:
    """The rank's card: ``cuda:{LOCAL_RANK % device_count}`` (the rank when
    no launcher set ``LOCAL_RANK``), or the device asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and world > 1:
        dev = _local_card(rank)
    return dev


def build_mesh(config: MeshConfig = MeshConfig(), world_size: int | None = None,
               rank: int | None = None, device: str | torch.device | None = None) -> Mesh:
    """The ``(data, model)`` mesh over every rank of the process group (or
    over ``world_size`` ranks, as rank ``rank``, for a layout-only mesh).
    ``data_parallel=-1`` takes every rank that ``model`` leaves; raises
    ValueError where ``model_parallel`` does not divide the world size or
    the two sizes do not multiply to it. Builds the sub-groups (every rank
    must call this with the same config) and, on a card, makes the rank's
    card the current one."""
    live = dist.is_available() and dist.is_initialized()
    n = world_size if world_size is not None else (dist.get_world_size() if live else 1)
    r = rank if rank is not None else (dist.get_rank() if live else 0)
    mp = max(1, config.model_parallel)
    if n % mp != 0:
        raise ValueError(f"model_parallel={mp} does not divide world size {n}")
    dp = config.data_parallel if config.data_parallel > 0 else n // mp
    if dp * mp != n:
        raise ValueError(f"data_parallel*model_parallel={dp * mp} != world size {n}")
    groups: dict[str, Any] = {config.data_axis: None, config.model_axis: None}
    if live and n > 1 and n == dist.get_world_size():
        # every rank creates every group, in one order
        if dp > 1:
            for m in range(mp):
                g = dist.new_group([d * mp + m for d in range(dp)])
                if r % mp == m:
                    groups[config.data_axis] = g
        if mp > 1:
            for d in range(dp):
                g = dist.new_group([d * mp + m for m in range(mp)])
                if r // mp == d:
                    groups[config.model_axis] = g
    dev = _device(device, r, n)
    if dev.type == "cuda" and n > 1:
        torch.cuda.set_device(dev)
    return Mesh({config.data_axis: dp, config.model_axis: mp}, r, dev, groups,
                config.data_axis, config.model_axis)


@functools.lru_cache(maxsize=1)
def default_mesh() -> Mesh:
    return build_mesh()


def capturable(mesh: Mesh | None) -> bool:
    """Whether a step over ``mesh`` can run as a captured CUDA graph: with
    no mesh or one rank, or where every group of more than one rank is
    NCCL's (its collectives are kernels a graph records). Gloo's are host
    calls, so a step over a gloo group, or over a layout-only mesh, stays
    eager. Every rank of a mesh decides alike, so all capture or none."""
    if mesh is None or mesh.world_size == 1:
        return True
    groups = [mesh.groups[a] for a in (mesh.data_axis, mesh.model_axis) if mesh.shape[a] > 1]
    return all(g is not None and dist.get_backend(g) == "nccl" for g in groups)


def warm_collectives(mesh: Mesh | None) -> None:
    """One all-reduce on each group of more than one rank, then a wait: NCCL
    sets a group's communicator up at its first collective, which must not
    be inside a capture. Every rank of the mesh calls it at the same point."""
    if mesh is None or mesh.world_size == 1:
        return
    from facerec_torch.parallel.collectives import all_reduce_

    for axis in (mesh.data_axis, mesh.model_axis):
        group = mesh.group(axis)
        if group is not None:
            all_reduce_(torch.zeros(1, device=mesh.device), group)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _rows(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} of {n} rows does not split over {parts} ranks")
    per = n // parts
    return slice(index * per, (index + 1) * per)


def batch_sharding(mesh: Mesh, n: int, data_axis: str = "data") -> slice:
    """This rank's rows of a batch of ``n``: the contiguous ``n / dp`` rows
    of its data index."""
    return _rows(n, mesh.size(data_axis), mesh.index(data_axis), "a batch")


def gallery_sharding(mesh: Mesh, capacity: int, model_axis: str = "model") -> slice:
    """This rank's gallery rows: ``[m * R, (m + 1) * R)`` of a gallery of
    ``capacity = mp * R`` rows, for model index ``m``."""
    return _rows(capacity, mesh.size(model_axis), mesh.index(model_axis), "a gallery")


def replicated(mesh: Mesh, n: int) -> slice:
    """Every row: what each rank holds of a replicated array."""
    return slice(0, n)


def _tensors(params: Any) -> list[torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return list(params.state_dict().values())
    if isinstance(params, dict):
        return [t for v in params.values() for t in _tensors(v)]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in _tensors(v)]
    return [params] if isinstance(params, torch.Tensor) else []


@torch.no_grad()
def shard_params(params: Any, mesh: Mesh) -> Any:
    """Replicate parameters: broadcast every tensor of ``params`` (a module's
    state dict, a dict, or a list of tensors, nested) from rank 0, in
    place, so every rank starts from rank 0's values. One broadcast per
    dtype and device. Returns ``params``."""
    if mesh.world_size == 1:
        return params
    buckets: dict[tuple, list[torch.Tensor]] = {}
    for t in _tensors(params):
        buckets.setdefault((t.dtype, t.device), []).append(t)
    from facerec_torch.parallel.collectives import broadcast_

    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        broadcast_(flat, None)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view(t.shape))
    return params


def shard_batch(batch: dict, mesh: Mesh, data_axis: str = "data") -> dict[str, torch.Tensor]:
    """This rank's rows of a global host batch (numpy arrays), on the mesh's
    device."""
    return {k: torch.from_numpy(np.ascontiguousarray(v[batch_sharding(mesh, len(v), data_axis)])
                                ).to(mesh.device) for k, v in batch.items()}


def pad_to_multiple(batch: Any, multiple: int) -> tuple[Any, int]:
    """Pad the leading dim of every array of ``batch`` (a dict, list or tuple
    of arrays, nested, or one array) with zeros to a multiple of
    ``multiple``, so that shards divide evenly; returns (padded batch, the
    original size)."""
    leaves = _leaves(batch)
    if not leaves:
        return batch, 0
    n = leaves[0].shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n

    def _pad(x):
        x = np.asarray(x)
        return np.pad(x, [(0, rem)] + [(0, 0)] * (x.ndim - 1))

    return _map(_pad, batch), n


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


# The data-parallel region of a train or eval step: BatchNorm reads it to
# normalise over the global batch, dropout to draw the global batch's mask.
_DATA_MESH: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar(
    "facerec_data_mesh", default=None)


@contextlib.contextmanager
def data_parallel(mesh: Mesh | None) -> Iterator[None]:
    """Within the block, models run as one slice of a batch sharded over
    ``mesh``'s data axis (nothing changes without a mesh or at data size 1)."""
    token = _DATA_MESH.set(mesh if mesh is not None and mesh.size(mesh.data_axis) > 1
                           else None)
    try:
        yield
    finally:
        _DATA_MESH.reset(token)


def sharded_data_mesh() -> Mesh | None:
    """The mesh of the enclosing ``data_parallel`` block, when its data axis
    has more than one rank."""
    return _DATA_MESH.get()
