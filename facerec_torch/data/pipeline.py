"""Device input pipeline (counterpart of ``facerec_tpu/data/pipeline.py``):
a background thread loads the next batches while the card computes, copies
each through pinned host memory to the card on a side stream, and the
consumer's stream waits for that copy before it uses the batch. With a
mesh every rank reads the same global batch and keeps its data slice
(``local_slice``), so a ``(dp, 1)`` run sees the data one process sees.
With tracing on (``utils.profiling``) the feed records each batch's
staging (``train.feed.stage``), the consumer's wait (``train.feed.wait``)
and the batches ready at each wait (``train.feed.depth``).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from facerec_torch import resolve_device
from facerec_torch.parallel.mesh import Mesh
from facerec_torch.utils import profiling


def local_slice(batch: dict, process_index: int | None = None,
                process_count: int | None = None) -> dict:
    """The contiguous rows of ``batch`` that belong to one of
    ``process_count`` ranks (default: this rank of the process group); the
    identity for one rank."""
    live = torch.distributed.is_available() and torch.distributed.is_initialized()
    pc = process_count if process_count is not None else (
        torch.distributed.get_world_size() if live else 1)
    if pc <= 1:
        return batch
    pi = process_index if process_index is not None else torch.distributed.get_rank()

    def _sl(x):
        per = x.shape[0] // pc
        return x[pi * per:(pi + 1) * per]

    return {k: _sl(v) for k, v in batch.items()}


def shard_put(batch: dict, mesh: Mesh) -> dict[str, torch.Tensor]:
    """This rank's slice of a batch (numpy arrays), on the mesh's device."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
            for k, v in batch.items()}


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put ``item`` unless the consumer has gone; returns False if it has."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


def prefetch_to_device(
    it: Iterable[dict],
    device: str | torch.device | None = None,
    depth: int = 2,
    mesh: Mesh | None = None,
) -> Iterator[dict[str, torch.Tensor]]:
    """Iterate ``it`` (dicts of numpy arrays) on a background thread,
    keeping up to ``depth`` batches on ``device`` (default: the CUDA card)
    ahead of the consumer. With ``mesh`` each batch is cut to this rank's
    data slice and put on the mesh's device. An error raised by ``it``
    re-raises in the consumer; a consumer that stops early stops the
    thread."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    data = (mesh.index(mesh.data_axis), mesh.size(mesh.data_axis)) if mesh is not None else None
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def _producer():
        try:
            for batch in it:
                with profiling.span("train.feed.stage"):
                    if data is not None:
                        batch = local_slice(batch, *data)
                    host = {k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in batch.items()}
                    if stream is None:
                        item = (host, None)
                    else:
                        with torch.cuda.device(dev), torch.cuda.stream(stream):
                            moved = {k: t.pin_memory().to(dev, non_blocking=True)
                                     for k, t in host.items()}
                            ready = torch.cuda.Event()
                            ready.record(stream)
                        item = (moved, ready)
                if not _put(q, item, stop):
                    return
        except BaseException as e:  # re-raised in the consumer
            err.append(e)
        finally:
            _put(q, end, stop)

    thread = threading.Thread(target=_producer, daemon=True)
    thread.start()
    try:
        while True:
            if profiling.enabled():  # the batches ready when the consumer asks
                profiling.count("train.feed.depth", q.qsize())
            with profiling.span("train.feed.wait"):
                item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            batch, ready = item
            if ready is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_event(ready)
                for t in batch.values():
                    t.record_stream(current)
            yield batch
    finally:
        stop.set()
        thread.join(timeout=60)


class InMemoryBatcher:
    """Batches over in-memory arrays (synthetic datasets, benchmarks), with
    the final partial batch padded and masked."""

    def __init__(self, arrays: dict[str, Any], batch_size: int, shuffle: bool = True, seed: int = 0):
        self.arrays = arrays
        n = len(next(iter(arrays.values())))
        if any(len(v) != n for v in arrays.values()):
            raise ValueError("arrays differ in length")
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return -(-self.n // self.batch_size)

    def epoch(self, epoch: int | None = None):
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        bs = self.batch_size
        for s in range(0, self.n, bs):
            idx = order[s : s + bs]
            batch = {k: v[idx] for k, v in self.arrays.items()}
            mask = np.ones(len(idx), np.float32)
            if len(idx) < bs:
                pad = bs - len(idx)
                batch = {
                    k: np.concatenate([v, np.zeros((pad, *v.shape[1:]), v.dtype)]) for k, v in batch.items()
                }
                mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            batch["mask"] = mask
            yield batch

    def __iter__(self):
        return self.epoch()
