"""Frame uploads that page-lock a reused host buffer in place.

A serving loop mostly fills the same few host buffers again and again: a
camera's or a decoder's ring, a benchmark's frame pool. The staged upload
copies each batch into pinned memory on the host and then DMAs it to the
card; for a 48 x 480 x 640 x 3 uint8 batch (44 MB) that host copy is the
request's noisiest part (2.5-4.2 ms at the median and 7.6-11.8 ms at the
95th percentile on the 8 cores beside an H100), since it runs on every
core and waits for the slowest. ``HostFrames`` registers such a buffer with
CUDA (``cudaHostRegister``) the second time the same array brings it, and
from then on uploads it with one DMA from the caller's own memory (1.5 ms,
steady) and no host copy. Registering costs about 9 ms once a buffer.

A buffer stays registered until the ``HostFrames`` is let go, and its array
is held until then, so its memory cannot be freed while CUDA has it
locked. At most ``MAX_BYTES`` are registered; past that, and for buffers
seen once, smaller than ``MIN_BYTES``, not owned by a numpy array, or
overlapping a registered one, the upload is staged as before. A
registration that CUDA refuses ends registering for good. Either way
the frames are on the card, or on their way from pinned memory that no
later upload reuses early, when ``upload`` returns, so the caller may
write its buffer again at once. The DMA runs on a stream of its own, so it
does not wait for work already queued on the card.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

SEEN = 16  # buffers remembered from their first upload
MAX_BYTES = 1 << 30  # registered at most, a pipeline
MIN_BYTES = 1 << 20  # below this the host copy is cheap


def _owner(arr: np.ndarray) -> np.ndarray | None:
    """The numpy array that owns ``arr``'s memory, or None."""
    base = arr
    while isinstance(base, np.ndarray) and base.base is not None:
        base = base.base
    return base if isinstance(base, np.ndarray) else None


def _clear_cuda_error() -> None:
    """Reset the runtime's last error after a failed registration, which the
    next kernel launch check would otherwise report as its own."""
    try:
        ctypes.CDLL("libcudart.so.12").cudaGetLastError()
    except OSError:
        pass


def _unregister(held: dict[tuple[int, int], np.ndarray]) -> None:
    """Unregister every buffer of ``held``, then let their arrays go."""
    if not held:
        return
    cudart = torch.cuda.cudart()
    for p, _ in held:
        if int(cudart.cudaHostUnregister(p)) != 0:
            _clear_cuda_error()
    held.clear()


class HostFrames:
    """Uploads of host frame batches to ``device`` (a CUDA card)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._room = MAX_BYTES  # bytes left to register
        self._stream: torch.cuda.Stream | None = None
        self._seen: dict[tuple[int, int], weakref.ref] = {}  # first uploads: (ptr, bytes) -> owner
        self._held: dict[tuple[int, int], np.ndarray] = {}  # registered: (ptr, bytes) -> owner
        weakref.finalize(self, _unregister, self._held)

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` (C-contiguous) as a tensor on the card."""
        host = torch.from_numpy(arr)
        if host.is_pinned() or self._register(arr):
            return self._dma(host)
        # the pinned block is not reused before the copy out of it is done
        return host.pin_memory().to(self.device, non_blocking=True)

    def _register(self, arr: np.ndarray) -> bool:
        """Whether ``arr``'s memory is now registered: at the second upload
        of the same owner's memory, within the limits."""
        owner = _owner(arr)
        if owner is None or arr.nbytes < MIN_BYTES:
            return False
        key = p, n = arr.ctypes.data, arr.nbytes
        ref = self._seen.pop(key, None)
        if ref is None or ref() is not owner:
            self._seen[key] = weakref.ref(owner)
            if len(self._seen) > SEEN:
                del self._seen[next(iter(self._seen))]
            return False
        if n > self._room or any(p < q + m and q < p + n for q, m in self._held):
            return False
        if int(torch.cuda.cudart().cudaHostRegister(p, n, 0)) != 0:
            _clear_cuda_error()
            self._room = 0
            return False
        self._held[key] = owner
        self._room -= n
        return True

    def _dma(self, host: torch.Tensor) -> torch.Tensor:
        """Page-locked ``host`` to the card on the upload stream; returns once
        the copy is done."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):  # allocated in, and written by, that stream
            x = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            x.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        done.synchronize()  # the copy is over before any later work is queued
        x.record_stream(torch.cuda.current_stream(self.device))
        return x
