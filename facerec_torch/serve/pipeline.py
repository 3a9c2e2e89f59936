"""The serving pipeline: detect -> align -> embed -> match on the card
(counterpart of ``facerec_tpu/serve/pipeline.py``).

One call of ``step`` runs the MTCNN cascade, box clean-up, the fused
eye-levelling align + crop (2-shear rotation kernel; or, with
``precise_align``, the exact gather warp of ``ops/image.py``), the ArcFace
embedder and the gallery top-k kernel over a fixed-size frame batch; each
frame yields up to ``max_faces`` masked slots. PyTorch runs eagerly, so the
step is a sequence of launches rather than one compiled program; the NMS
fixed points read the host once per block of rounds, so ``dispatch_demo``
returns only once detection is done.

The demo's path, ``packed_step``, packs every field the host needs into one
[B, F, 19] f32 tensor, so a frame costs one device-to-host copy.

With a ``(data, model)`` mesh (one rank per card, ``parallel/mesh.py``),
as the JAX step's: the frames of a batch are split over ``data``, each
rank uploading and running its slice (detect, the align with its rotation
kernel, embed; every ``model`` rank of a data index computes the same
slice), and the gallery rows are split over ``model``. Each rank then
runs the top-k kernel on its own rows with its own valid count, computed
on the device from the global count (no host read), and the shards'
winners are merged exactly (``global_topk_merge``); an index is ``shard *
R + local``. ``process``, ``identify`` and the benchmarks answer for this
rank's frames: rows ``[d B / dp, (d + 1) B / dp)`` of the batch.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn

from facerec_torch import resolve_device
from facerec_torch.config import ServeConfig
from facerec_torch.detect.mtcnn import MTCNN
from facerec_torch.ops.arcface import l2_normalize
from facerec_torch.ops.gallery import cosine_to_euclidean, gallery_topk
from facerec_torch.ops.image import align_and_crop_batched, bbox_with_margin
from facerec_torch.ops.warp_fast import align_and_crop_fast_batched
from facerec_torch.parallel.collectives import global_topk_merge
from facerec_torch.parallel.mesh import Mesh, batch_sharding
from facerec_torch.serve.gallery import GalleryStore

DEFAULT_LANDMARKS = [[40.0, 60.0], [120.0, 60.0], [80.0, 90.0], [50.0, 120.0], [110.0, 120.0]]


class PipelineResult(NamedTuple):
    boxes: torch.Tensor  # [B, F, 4]
    probs: torch.Tensor  # [B, F]
    landmarks: torch.Tensor  # [B, F, 5, 2]
    valid: torch.Tensor  # [B, F] detection valid & above det threshold
    embeddings: torch.Tensor  # [B, F, D]
    match_scores: torch.Tensor  # [B, F, K] cosine similarities
    match_indices: torch.Tensor  # [B, F, K] gallery rows
    match_distances: torch.Tensor  # [B, F, K] euclidean
    is_match: torch.Tensor  # [B, F] best distance <= recognition threshold


class FacePipeline:
    """End-to-end face recognition over fixed-size frame batches.

    ``detector``: an ``MTCNN`` built for ``frame_hw``; ``embedder``: a module
    whose ``embed(crops [N, S, S, 3]) -> [N, D]`` takes raw 0..255 crops
    (``models.arcface.build_embedder``). Both must live on ``device``
    (default: the CUDA card; with no card the constructor raises).
    ``precise_align``: align with the exact per-pixel gather warp on f32
    frames (f32 crops) instead of the fast path and its rotation kernel.
    ``mesh``: the ``(data, model)`` mesh the step runs over (every rank of
    it builds the pipeline and calls the same methods); the pipeline lives
    on the mesh's device, where the detector and the embedder must be."""

    def __init__(self, config: ServeConfig, frame_hw: tuple[int, int], detector: MTCNN,
                 embedder: nn.Module, embed_dim: int = 512, face_margin: float = 0.0,
                 device: str | torch.device | None = None, precise_align: bool = False,
                 mesh: Mesh | None = None):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.precise_align = precise_align
        self.config = config
        self.frame_hw = tuple(frame_hw)
        self.detector = detector
        self.embedder = embedder
        self.embed_dim = embed_dim
        self.face_margin = face_margin
        self.gallery = GalleryStore(capacity=config.gallery_capacity, dim=embed_dim,
                                    dtype=config.gallery_dtype, device=self.device, mesh=mesh)
        s = float(config.embed_size)
        self._default_box = torch.tensor([0.0, 0.0, s, s], device=self.device)
        self._default_lmk = torch.tensor(DEFAULT_LANDMARKS, device=self.device)

    @torch.no_grad()
    def step(self, frames: torch.Tensor) -> PipelineResult:
        """frames: [B, H, W, 3] uint8/float on the pipeline's device (with a
        mesh: this rank's slice of the batch, as ``upload`` gives it)."""
        cfg = self.config
        b, f = frames.shape[0], cfg.max_faces
        d = self.detector.detect(frames)
        valid = d.valid & (d.probs >= cfg.detection_threshold)
        boxes = d.boxes
        if self.face_margin > 0:
            boxes = bbox_with_margin(boxes, self.face_margin, self.frame_hw)
        # clamp to the frame and give invalid slots a small fixed box, so the
        # align stage never resamples from degenerate boxes
        h, w = self.frame_hw
        x1 = torch.clamp(boxes[..., 0], 0.0, w - 2.0)
        y1 = torch.clamp(boxes[..., 1], 0.0, h - 2.0)
        x2 = torch.clamp(torch.maximum(boxes[..., 2], x1 + 1.0), max=float(w))
        y2 = torch.clamp(torch.maximum(boxes[..., 3], y1 + 1.0), max=float(h))
        boxes = torch.where(valid[..., None], torch.stack([x1, y1, x2, y2], dim=-1),
                            self._default_box)
        landmarks = torch.where(valid[..., None, None], d.landmarks, self._default_lmk)
        crops = self.align(frames, boxes, landmarks)
        crops = crops.reshape(b * f, cfg.embed_size, cfg.embed_size, 3)
        emb = l2_normalize(self.embedder.embed(crops).float())
        count = self.gallery.count_device
        scores, idx = self.match(emb)
        dist = cosine_to_euclidean(scores)
        emb = emb.reshape(b, f, -1)
        scores = scores.reshape(b, f, cfg.top_k)
        idx = idx.reshape(b, f, cfg.top_k)
        dist = dist.reshape(b, f, cfg.top_k)
        is_match = valid & (dist[..., 0] <= cfg.recognition_threshold) & (count > 0)
        return PipelineResult(boxes, d.probs, d.landmarks, valid, emb, scores, idx, dist,
                              is_match)

    def match(self, emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k cosine matches of unit embeddings [N, D] in the gallery:
        (scores [N, k], global row indices [N, k]). With the rows sharded
        over ``model``, the top-k kernel on this rank's rows and the exact
        merge over the shards."""
        g, k = self.gallery, self.config.top_k
        if g.mesh is None:
            return gallery_topk(emb, g.embeddings, g.count_device, k=k)
        v, i = gallery_topk(emb, g.embeddings, g.local_count_device(), k=k)
        v, i, shard = global_topk_merge(v, i, k, g.mesh, g.mesh.model_axis)
        return v, shard * g.shard_rows + i

    def align(self, frames: torch.Tensor, boxes: torch.Tensor, landmarks: torch.Tensor
              ) -> torch.Tensor:
        """[B, F, S, S, 3] eye-levelled crops: bf16 from the fast path, f32
        from the exact warp under ``precise_align``."""
        if self.precise_align:
            return align_and_crop_batched(frames.float(), boxes, landmarks,
                                          self.config.embed_size)
        return align_and_crop_fast_batched(frames.float(), boxes, landmarks,
                                           self.config.embed_size, out_dtype=torch.bfloat16)

    @torch.no_grad()
    def packed_step(self, frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The step, with every host-needed field packed into one [B, F, 19]
        f32 tensor (columns: valid, prob, box x4, landmarks x10, is_match,
        top-1 gallery row, top-1 distance); the embeddings [B, F, D] stay on
        the device."""
        r = self.step(frames)
        b, f = r.probs.shape
        flat = torch.cat([
            r.valid[..., None].float(),
            r.probs[..., None].float(),
            r.boxes.float(),
            r.landmarks.reshape(b, f, 10).float(),
            r.is_match[..., None].float(),
            r.match_indices[..., :1].float(),
            r.match_distances[..., :1].float(),
        ], dim=-1)
        return flat, r.embeddings

    def dispatch_demo(self, frames: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Upload and run the packed step; returns the device tensors
        (packed, embeddings) without waiting for the card to finish them."""
        return self.packed_step(self.upload(frames))

    def process_demo(self, frames: np.ndarray) -> tuple[np.ndarray, torch.Tensor]:
        """(packed [B, F, 19] on the host, one copy; device embeddings)."""
        flat, emb = self.dispatch_demo(frames)
        return flat.cpu().numpy(), emb

    def faces_from_packed(self, flat: np.ndarray) -> list[list[dict]]:
        """Decode a packed [B, F, 19] array into ``identify``-shaped face
        dicts, without ``embedding``; ``slot`` is the face slot, for fetching
        its device-resident embedding on demand."""
        out = []
        for bi in range(flat.shape[0]):
            faces = []
            for fi in range(flat.shape[1]):
                row = flat[bi, fi]
                if row[0] < 0.5:
                    continue
                matched = row[16] >= 0.5
                gi = int(row[17])
                faces.append({
                    "slot": fi,
                    "box": row[2:6].tolist(),
                    "prob": float(row[1]),
                    "landmarks": row[6:16].reshape(5, 2).tolist(),
                    "name": self.gallery.name_of(gi) if matched else "Unknown",
                    "distance": float(row[18]),
                })
            out.append(faces)
        return out

    def upload(self, frames: np.ndarray) -> torch.Tensor:
        """Host frames to the device: uint8 travels as uint8 (a quarter of
        the bytes), anything else as float32. With a mesh, only this rank's
        slice of the batch travels."""
        arr = np.asarray(frames)
        if self.mesh is not None:
            arr = arr[batch_sharding(self.mesh, len(arr), self.mesh.data_axis)]
        if arr.dtype != np.uint8:
            arr = arr.astype(np.float32, copy=False)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def process(self, frames: np.ndarray) -> PipelineResult:
        """frames: [B, H, W, 3] uint8/float RGB -> device results (with a
        mesh, of this rank's slice of the frames); the gallery and its count
        stay on the device."""
        return self.step(self.upload(frames))

    def identify(self, frames: np.ndarray) -> list[list[dict]]:
        """Per frame, a list of face dicts with names (the demo's shape)."""
        r = PipelineResult(*(t.cpu().numpy() for t in self.process(frames)))
        out = []
        for bi in range(r.boxes.shape[0]):
            faces = []
            for fi in range(r.boxes.shape[1]):
                if not r.valid[bi, fi]:
                    continue
                matched = bool(r.is_match[bi, fi])
                gi = int(r.match_indices[bi, fi, 0])
                faces.append({
                    "box": r.boxes[bi, fi].tolist(),
                    "prob": float(r.probs[bi, fi]),
                    "landmarks": r.landmarks[bi, fi].tolist(),
                    "name": self.gallery.name_of(gi) if matched else "Unknown",
                    "distance": float(r.match_distances[bi, fi, 0]),
                    "embedding": np.asarray(r.embeddings[bi, fi]),
                })
            out.append(faces)
        return out

    def benchmark(self, frames: np.ndarray, iters: int = 20, warmup: int = 2
                  ) -> dict[str, float]:
        """Steady-state throughput of the step on device-resident frames,
        timed with CUDA events after ``warmup`` steps. Runs only on a card."""
        self._check_card()
        x = self.upload(frames)
        return self._timed(lambda: self.step(x), x.shape[0], iters, warmup)

    def benchmark_transfer(self, frames: np.ndarray, iters: int = 12, warmup: int = 2
                           ) -> dict[str, float]:
        """Throughput with the upload included: every iteration uploads a
        fresh host uint8 batch (the camera's dtype; a 3-byte salt in one
        pixel makes each upload distinct) and runs the step. Runs only on a
        card."""
        self._check_card()
        base = np.ascontiguousarray(np.clip(np.asarray(frames), 0, 255).astype(np.uint8))
        rows = (slice(0, len(base)) if self.mesh is None
                else batch_sharding(self.mesh, len(base), self.mesh.data_axis))
        cursor = [0]

        def one():
            i = cursor[0]
            cursor[0] += 1
            base[rows.start, 0, 0, :] = (i & 0xFF, (i >> 8) & 0xFF, 1)
            self.step(self.upload(base))  # pageable: base is read before upload returns

        return self._timed(one, rows.stop - rows.start, iters, warmup)

    def _check_card(self) -> None:
        if self.device.type != "cuda":
            raise RuntimeError("benchmark measures the CUDA card; this pipeline is on "
                               f"{self.device}")

    def _timed(self, fn, b: int, iters: int, warmup: int) -> dict[str, float]:
        """``fn`` timed with CUDA events after ``warmup`` calls; the wall
        clock beside it."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(self.device)
        wall = (time.perf_counter() - t0) / iters
        dt = start.elapsed_time(end) / 1e3 / iters
        return {
            "sec_per_batch": dt,
            "host_sec_per_batch": wall,
            "frames_per_sec": b / dt,
            "faces_per_sec": b * self.config.max_faces / dt,
        }


def calc_iou(box_a, box_b) -> float:
    """IOU for host-side face tracking across frames (reference app.py:126-147)."""
    xa = max(box_a[0], box_b[0])
    ya = max(box_a[1], box_b[1])
    xb = min(box_a[2], box_b[2])
    yb = min(box_a[3], box_b[3])
    inter = max(0.0, xb - xa) * max(0.0, yb - ya)
    area_a = (box_a[2] - box_a[0]) * (box_a[3] - box_a[1])
    area_b = (box_b[2] - box_b[0]) * (box_b[3] - box_b[1])
    denom = area_a + area_b - inter
    return inter / denom if denom > 0 else 0.0


class FaceTracker:
    """IOU-based face-ID tracking across frames (reference app.py:183-246)."""

    def __init__(self, iou_threshold: float = 0.3):
        self.iou_threshold = iou_threshold
        self.prev: list[tuple[int, list[float]]] = []  # (face_id, box)
        self._next_id = 0

    def update(self, boxes: list[list[float]]) -> list[int]:
        ids = []
        used = set()
        for box in boxes:
            best, best_iou = -1, self.iou_threshold
            for fid, pbox in self.prev:
                if fid in used:
                    continue
                iou = calc_iou(box, pbox)
                if iou > best_iou:
                    best, best_iou = fid, iou
            if best < 0:
                best = self._next_id
                self._next_id += 1
            used.add(best)
            ids.append(best)
        self.prev = list(zip(ids, boxes))
        return ids
