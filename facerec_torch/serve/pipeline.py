"""The serving pipeline: detect -> align -> embed -> match on the card
(counterpart of ``facerec_tpu/serve/pipeline.py``).

One call of ``step`` runs the MTCNN cascade, box clean-up, the fused
eye-levelling align + crop (2-shear rotation kernel; or, with
``precise_align``, the exact gather warp of ``ops/image.py``), the ArcFace
embedder and the gallery top-k kernel over a fixed-size frame batch; each
frame yields up to ``max_faces`` masked slots. ``step`` is the eager body,
the counterpart of JAX's ``_step_raw``: a sequence of launches. Every shape
in it is static and no op in it waits on the host (the NMS fixed points run
to convergence in their own kernel), so on a card (with a mesh: see
below) the pipeline runs it as one captured program, the counterpart of
the jitted step: ``run_step``, ``packed_step``, ``process``, ``dispatch_demo``,
``identify``, ``benchmark`` and ``benchmark_transfer`` replay a
``torch.cuda.CUDAGraph`` of the step. The graph is captured at the first
call for each frame shape and dtype (as jit traces once per shape), after
two eager warm-up runs on a side stream; a capture that fails raises. The
frames are copied into the graph's static input and its outputs copied out,
both in stream order, so every call returns buffers of its own, which no
later replay overwrites, and returns before the card has finished them
(``upload``'s copy to the card does not wait for earlier work either: it
runs from pinned memory, on its own stream for a reused host buffer,
``serve/host_frames.py``): ``dispatch_demo`` lets the demo
dispatch frame N + 1 before it reads frame N back. The graph reads the detector's and embedder's weights and the
gallery's ``embeddings`` and count in place, so an enrolment or a removal
between replays is seen by the next one; replacing the gallery, the
detector or the embedder (or changing ``precise_align``, ``face_margin`` or
the config) captures anew. The pipeline's graphs share one memory pool,
released with the pipeline. On the CPU the step runs eagerly.

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
rank's frames: rows ``[d B / dp, (d + 1) B / dp)`` of the batch. Where
every group of the mesh is NCCL's (``parallel.mesh.capturable``: one rank
per card) the mesh step is captured and replayed as the step without a mesh
is, the merge's all-gather a node of the graph: every rank warms its
groups' collectives (``warm_collectives``) and runs the warm-ups before it
captures, and every rank calls the same entry points in the same order, so
all ranks capture, and then replay, together. Over gloo (ranks that share a
card) the step stays eager: gloo's collectives are host calls, which a
graph cannot record.
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
from facerec_torch.ops import kernels
from facerec_torch.ops.arcface import l2_normalize
from facerec_torch.ops.gallery import cosine_to_euclidean, gallery_topk
from facerec_torch.ops.image import align_and_crop_batched, bbox_with_margin
from facerec_torch.ops.warp_fast import align_and_crop_fast_batched
from facerec_torch.parallel.collectives import global_topk_merge
from facerec_torch.parallel.mesh import Mesh, batch_sharding, capturable, warm_collectives
from facerec_torch.serve.gallery import GalleryStore
from facerec_torch.serve.host_frames import HostFrames
from facerec_torch.utils import profiling

DEFAULT_LANDMARKS = [[40.0, 60.0], [120.0, 60.0], [80.0, 90.0], [50.0, 120.0], [110.0, 120.0]]
WARMUP_RUNS = 2  # eager runs of the step on a side stream before its capture


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


class _Captured(NamedTuple):
    """One captured step: its graph, static input and static outputs, and
    the launches of each port kernel one replay makes (``ops.kernels``)."""
    graph: torch.cuda.CUDAGraph
    frames: torch.Tensor
    outputs: tuple
    launches: dict[str, int]


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
        self._graphs: dict[tuple, _Captured] = {}
        self._graph_inputs: tuple | None = None  # what the graphs read in place
        self._pool = None  # the graphs' shared memory pool
        self._host_frames = HostFrames(self.device) if self.device.type == "cuda" else None

    @torch.no_grad()
    def step(self, frames: torch.Tensor) -> PipelineResult:
        """frames: [B, H, W, 3] uint8/float on the pipeline's device (with a
        mesh: this rank's slice of the batch, as ``upload`` gives it)."""
        cfg = self.config
        b, f = frames.shape[0], cfg.max_faces
        dev = frames.device
        with profiling.device_span("serve.step.detect", dev):
            d = self.detector.detect(frames)
        with profiling.device_span("serve.step.align", dev):
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
        with profiling.device_span("serve.step.embed", dev):
            crops = crops.reshape(b * f, cfg.embed_size, cfg.embed_size, 3)
            emb = l2_normalize(self.embedder.embed(crops).float())
        with profiling.device_span("serve.step.match", dev):
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

    @staticmethod
    def pack(r: PipelineResult) -> torch.Tensor:
        """Every host-needed field of a step's result in one [B, F, 19] f32
        tensor (columns: valid, prob, box x4, landmarks x10, is_match, top-1
        gallery row, top-1 distance)."""
        b, f = r.probs.shape
        return torch.cat([
            r.valid[..., None].float(),
            r.probs[..., None].float(),
            r.boxes.float(),
            r.landmarks.reshape(b, f, 10).float(),
            r.is_match[..., None].float(),
            r.match_indices[..., :1].float(),
            r.match_distances[..., :1].float(),
        ], dim=-1)

    @torch.no_grad()
    def _packed(self, frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The eager body of ``packed_step``."""
        r = self.step(frames)
        return self.pack(r), r.embeddings

    def packed_step(self, frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The step with its result packed (``pack``) into one [B, F, 19] f32
        tensor, and the embeddings [B, F, D], which stay on the device.
        Replayed from its own CUDA graph on a card (with a mesh: where it is
        ``capturable``)."""
        return self._run("packed", frames)

    def run_step(self, frames: torch.Tensor) -> PipelineResult:
        """``step`` on frames on the pipeline's device, replayed from its
        CUDA graph on a card (with a mesh: where it is ``capturable``; eager
        otherwise); the result is in buffers of its own, and the call
        returns before the card has finished it."""
        return self._run("step", frames)

    def _run(self, kind: str, frames: torch.Tensor):
        body = self.step if kind == "step" else self._packed
        if self.device.type != "cuda" or not capturable(self.mesh):
            return body(frames)
        g = self.gallery
        inputs = (self.detector, self.embedder, g.embeddings, g.count_device)
        if self._graph_inputs is None or any(a is not b for a, b in zip(inputs,
                                                                        self._graph_inputs)):
            self._graphs.clear()  # a graph reads these in place: a new one captures anew
            self._graph_inputs = inputs
            # a pool is shared only while a graph holds it: the new graphs take a new one
            self._pool = None
        key = (kind, tuple(frames.shape), frames.dtype, self.precise_align, self.face_margin,
               self.config, profiling.enabled())
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._graphs[key] = self._capture(body, frames)
        cap.frames.copy_(frames)
        cap.graph.replay()
        kernels.advance(cap.launches)
        out = [t.clone() for t in cap.outputs]  # JAX returns fresh buffers too
        return PipelineResult(*out) if kind == "step" else tuple(out)

    def _capture(self, body, frames: torch.Tensor) -> _Captured:
        """Warm ``body`` up on a side stream, then capture it on a static
        copy of ``frames`` into the pipeline's pool. Raises if the capture
        fails; the launch counts are left as the warm-up made them, since a
        capture launches nothing."""
        dev = frames.device
        warm_collectives(self.mesh)
        with torch.cuda.device(dev):
            static = frames.clone()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    body(static)
            torch.cuda.current_stream(dev).wait_stream(side)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            before = kernels.launches()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                outputs = body(static)
            recorded = {k: n - before[k] for k, n in kernels.launches().items()}
            kernels.advance({k: -n for k, n in recorded.items()})
        return _Captured(graph, static, tuple(outputs), recorded)

    def dispatch_demo(self, frames: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Upload and enqueue the packed step; returns the device tensors
        (packed, embeddings) without waiting for the card to finish them
        (on a card, a replay of the captured packed step)."""
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
        slice of the batch travels. To a card the frames go through pinned
        memory (``HostFrames``: a host buffer that the caller uploads again
        is page-locked in place, and its copy to the card is awaited), and
        the call returns once the caller may write its buffer again: the
        copy to the card is not queued behind the work already on the
        stream, as a copy from pageable memory would be."""
        arr = np.asarray(frames)
        if self.mesh is not None:
            arr = arr[batch_sharding(self.mesh, len(arr), self.mesh.data_axis)]
        if arr.dtype != np.uint8:
            arr = arr.astype(np.float32, copy=False)
        arr = np.ascontiguousarray(arr)
        if self._host_frames is None:
            return torch.from_numpy(arr).to(self.device)
        return self._host_frames.upload(arr)

    def process(self, frames: np.ndarray) -> PipelineResult:
        """frames: [B, H, W, 3] uint8/float RGB -> device results (with a
        mesh, of this rank's slice of the frames); the gallery and its count
        stay on the device."""
        return self.run_step(self.upload(frames))

    def identify(self, frames: np.ndarray) -> list[list[dict]]:
        """Per frame, a list of face dicts with names (the demo's shape). A
        request of the tracing registry (``utils.profiling``): the host's
        parts ``serve.upload``, ``serve.launch``, ``serve.readback`` and
        ``serve.decode``, and ``serve.valid_slots``."""
        with profiling.request("serve.request", self.device):
            with profiling.span("serve.upload"):
                x = self.upload(frames)
            with profiling.span("serve.launch"):
                res = self.run_step(x)
            with profiling.span("serve.readback"):
                r = PipelineResult(*(t.cpu().numpy() for t in res))
            if profiling.enabled():  # the card has finished the step: read its stamps
                profiling.harvest(self.device)
                profiling.count("serve.valid_slots", int(r.valid.sum()))
            with profiling.span("serve.decode"):
                return self._decode(r)

    def _decode(self, r: PipelineResult) -> list[list[dict]]:
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
        """Steady-state throughput of the step (``run_step``: the captured
        graph) on device-resident frames, timed with CUDA events after
        ``warmup`` steps. Runs only on a card."""
        self._check_card()
        x = self.upload(frames)
        return self._timed(lambda: self.run_step(x), x.shape[0], iters, warmup)

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
            self.run_step(self.upload(base))  # base is copied out before upload returns

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
