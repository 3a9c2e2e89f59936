"""Reference-face gallery store (counterpart of ``facerec_tpu/serve/gallery.py``).

Host-side names around a capacity-padded, device-resident embedding matrix.
Entries occupy a valid prefix of ``capacity`` (compacted on delete), so the
matching kernel's ``count`` mask stays a prefix. ``count`` also lives on the
device as an int32 scalar, which the match kernel reads from device memory:
the serve step needs no host read for it. Persistence keeps the on-disk
contract of the JAX package (a pickle mapping name -> f32 embedding, plus
one JPEG per reference face), so a gallery saved by either package loads in
the other; ``load`` also reads the original reference app's list pickle,
which the JAX package does not. The port updates the matrix in place. Normalisation is always
in f32: on the host for ``add``/``add_many``, on the device for
``add_many_device``.

With a mesh whose ``model`` axis has ``mp`` ranks, each rank holds only its
row range ``[m R, (m + 1) R)`` of the ``capacity = mp R`` rows on its card
(``embeddings`` is that shard); the names and the count are global and
replicated on every rank. The writes keep the one-process layout: each
rank writes the rows of an enrolment that fall in its range, ``remove``
shifts the tail down across the shard boundaries (each shard's first row
moves to the previous shard's last slot, ``ppermute_ring``), and ``save``
gathers the valid rows to rank 0, which writes the one-process file.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from facerec_torch import resolve_device
from facerec_torch.config import FACE_REFERENCES_DIR
from facerec_torch.parallel.collectives import all_gather, ppermute_ring
from facerec_torch.parallel.mesh import Mesh, gallery_sharding


def _dtype(dtype: torch.dtype | str) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class GalleryStore:
    def __init__(self, capacity: int = 1024, dim: int = 512,
                 dtype: torch.dtype | str = torch.float32,
                 device: str | torch.device | None = None, mesh: Mesh | None = None):
        """``mesh``: hold this rank's row range of the ``model`` axis, on the
        mesh's device (``device`` is then not read)."""
        self.mesh = mesh if mesh is not None and mesh.size(mesh.model_axis) > 1 else None
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.capacity = capacity
        self.dim = dim
        self.dtype = _dtype(dtype)
        rows = (gallery_sharding(self.mesh, capacity, self.mesh.model_axis)
                if self.mesh is not None else slice(0, capacity))
        self.lo, self.hi = rows.start, rows.stop
        self.embeddings = torch.zeros((self.hi - self.lo, dim), dtype=self.dtype,
                                      device=self.device)
        self.names: list[str] = []
        self._count_dev = torch.zeros((), dtype=torch.int32, device=self.device)

    @property
    def count(self) -> int:
        return len(self.names)

    @property
    def count_device(self) -> torch.Tensor:
        """Device-resident valid-prefix length of the whole gallery (int32
        scalar)."""
        return self._count_dev

    @property
    def shard_rows(self) -> int:
        """Rows of each shard (the capacity on one rank)."""
        return self.hi - self.lo

    @property
    def local_count(self) -> int:
        """Valid rows of this rank's shard."""
        return min(max(self.count - self.lo, 0), self.shard_rows)

    def local_count_device(self) -> torch.Tensor:
        """``local_count`` computed on the device from ``count_device`` (no
        host read)."""
        return torch.clamp(self._count_dev - self.lo, 0, self.shard_rows)

    def _set_count(self) -> None:
        self._count_dev.fill_(self.count)

    def _span(self, start: int, n: int) -> tuple[int, int]:
        """The part ``[a, b)`` of the global rows ``[start, start + n)`` that
        this rank holds (none when ``a >= b``)."""
        return max(start, self.lo), min(start + n, self.hi)

    def add(self, name: str, embedding: np.ndarray) -> int:
        if self.count >= self.capacity:
            raise ValueError(f"gallery full (capacity {self.capacity})")
        emb = np.asarray(embedding, np.float32).reshape(-1)
        if emb.shape[0] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {emb.shape[0]}")
        emb = emb / max(np.linalg.norm(emb), 1e-12)
        if self.lo <= self.count < self.hi:
            self.embeddings[self.count - self.lo] = torch.from_numpy(emb).to(self.device,
                                                                             self.dtype)
        self.names.append(name)
        self._set_count()
        return self.count - 1

    def add_many(self, names: list[str], embeddings: np.ndarray) -> list[int]:
        """Bulk enrollment: normalised on the host, one upload."""
        if not names:
            return []
        embs = np.asarray(embeddings, np.float32).reshape(len(names), -1)
        if embs.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {embs.shape[1]}")
        if self.count + len(names) > self.capacity:
            raise ValueError(
                f"gallery full: {self.count}+{len(names)} > capacity {self.capacity}")
        embs = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-12)
        start = self.count
        a, b = self._span(start, len(names))
        if a < b:
            self.embeddings[a - self.lo:b - self.lo] = torch.from_numpy(
                embs[a - start:b - start]).to(self.device, self.dtype)
        self.names.extend(str(n) for n in names)
        self._set_count()
        return list(range(start, self.count))

    def add_many_device(self, names: list[str], embeddings: torch.Tensor) -> list[int]:
        """Bulk enrollment from embeddings already on the device (the embed
        stage's own output, or a generated gallery): normalised in f32 on
        the device and spliced into the valid prefix, with no host copy of
        the rows. At 524,288 x 512 that saves a 1 GiB upload. With a mesh
        every rank passes the same rows and keeps those of its range."""
        if not names:
            return []
        if embeddings.ndim != 2 or tuple(embeddings.shape) != (len(names), self.dim):
            raise ValueError(f"expected [{len(names)}, {self.dim}] embeddings, "
                             f"got {tuple(embeddings.shape)}")
        if self.count + len(names) > self.capacity:
            raise ValueError(
                f"gallery full: {self.count}+{len(names)} > capacity {self.capacity}")
        start = self.count
        a, b = self._span(start, len(names))
        if a < b:
            emb = embeddings[a - start:b - start].to(device=self.device, dtype=torch.float32)
            emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)
            self.embeddings[a - self.lo:b - self.lo] = emb.to(self.dtype)
        self.names.extend(str(n) for n in names)
        self._set_count()
        return list(range(start, self.count))

    def remove(self, name: str) -> bool:
        """Drop ``name``'s row and shift the rows after it down one slot.
        With a mesh every rank of the ``model`` axis calls it together."""
        if name not in self.names:
            return False
        i = self.names.index(name)
        c = self.count
        lo, hi = self.lo, self.hi
        # the next shard's first row, which slides into this shard's last slot
        incoming = (ppermute_ring(self.embeddings[0].clone(), self.mesh, self.mesh.model_axis,
                                  shift=-1) if self.mesh is not None else None)
        a, b = max(i, lo), min(c - 1, hi - 1)  # rows whose source lies in this shard
        if a < b:  # compact: shift the tail down one slot
            self.embeddings[a - lo:b - lo] = self.embeddings[a + 1 - lo:b + 1 - lo].clone()
        if incoming is not None and max(i, lo) <= hi - 1 < c - 1:
            self.embeddings[hi - 1 - lo] = incoming
        if lo <= c - 1 < hi:
            self.embeddings[c - 1 - lo] = 0
        self.names.pop(i)
        self._set_count()
        return True

    def rename(self, old: str, new: str) -> bool:
        if old not in self.names:
            return False
        self.names[self.names.index(old)] = new
        return True

    def clear(self) -> None:
        self.names.clear()
        self.embeddings.zero_()
        self._set_count()

    def name_of(self, index: int) -> str:
        return self.names[index] if 0 <= index < self.count else "Unknown"

    # -- persistence (reference face_references/ contract) ---------------------
    def save(self, directory: str | Path | None = None,
             images: dict[str, np.ndarray] | None = None) -> Path:
        """Write the gallery (with a mesh: every rank calls it, the rows are
        gathered and rank 0 writes)."""
        d = Path(directory or FACE_REFERENCES_DIR)
        rows = self.embeddings
        if self.mesh is not None:
            rows = all_gather(rows, self.mesh, self.mesh.model_axis)
        if self.mesh is None or self.mesh.is_primary:
            d.mkdir(parents=True, exist_ok=True)
            host = rows[: self.count].float().cpu().numpy()
            refs = {n: host[i].copy() for i, n in enumerate(self.names)}
            with (d / "face_references.pkl").open("wb") as f:
                pickle.dump(refs, f)
            if images:
                from PIL import Image

                for n, img in images.items():
                    Image.fromarray(np.asarray(img, np.uint8)).save(d / f"{n}.jpg")
        if self.mesh is not None:
            self.mesh.barrier()  # the file exists before any rank loads it
        return d

    @classmethod
    def load(cls, directory: str | Path | None = None, capacity: int = 1024,
             dtype: torch.dtype | str = torch.float32,
             device: str | torch.device | None = None,
             mesh: Mesh | None = None) -> "GalleryStore":
        """Load a gallery this package or ``facerec_tpu`` saved (a dict name
        -> embedding), or one the original reference app saved (a list of
        ``{"name", "embedding_numpy", "image_path"}`` dicts, whose repeated
        names stay separate rows). The pickle is unpickled: load only
        galleries you wrote."""
        d = Path(directory or FACE_REFERENCES_DIR)
        pkl = d / "face_references.pkl"
        if not pkl.exists():
            return cls(capacity=capacity, dtype=dtype, device=device, mesh=mesh)
        with pkl.open("rb") as f:
            refs = pickle.load(f)
        if not refs:
            return cls(capacity=capacity, dtype=dtype, device=device, mesh=mesh)
        if isinstance(refs, dict):
            names, embs = list(refs), list(refs.values())
        else:
            names = [r["name"] for r in refs]
            embs = [r["embedding_numpy"] for r in refs]
        rows = [np.asarray(e, np.float32).reshape(-1) for e in embs]
        store = cls(capacity=capacity, dim=rows[0].shape[0], dtype=dtype, device=device,
                    mesh=mesh)
        store.add_many([str(n) for n in names], np.stack(rows))
        return store
