"""The plain reference of a serve request: detect, align, embed and the
gallery's top-1 for a batch of frames, in the faces-per-frame form the
served ``identify`` answers in."""

from __future__ import annotations

import torch

from perfbench.reference import align as align_ref
from perfbench.reference import mtcnn
from perfbench.reference.match import Gallery
from perfbench.reference.precision import Precision


def embed_faces(p: Precision, embed_fn, frames: torch.Tensor, boxes: torch.Tensor,
                landmarks: torch.Tensor, size: int) -> torch.Tensor:
    """frames [B, H, W, 3] f32, boxes [B, F, 4], landmarks [B, F, 5, 2] ->
    unit embeddings [B, F, D] of the aligned crops."""
    crops = align_ref.align(p, frames, boxes, landmarks, size)
    b, f = boxes.shape[:2]
    return embed_fn(p, crops.reshape(b * f, size, size, 3)).reshape(b, f, -1)


def clean_boxes(boxes: torch.Tensor, frame_hw) -> torch.Tensor:
    """Clamp boxes to the frame, at least a pixel wide and high."""
    h, w = frame_hw
    x1 = torch.clamp(boxes[..., 0], 0.0, w - 2.0)
    y1 = torch.clamp(boxes[..., 1], 0.0, h - 2.0)
    x2 = torch.clamp(torch.maximum(boxes[..., 2], x1 + 1.0), max=float(w))
    y2 = torch.clamp(torch.maximum(boxes[..., 3], y1 + 1.0), max=float(h))
    return torch.stack([x1, y1, x2, y2], dim=-1)


def serve(p: Precision, det_weights: dict, spec: mtcnn.DetectorSpec, embed_fn, size: int,
          gallery: Gallery, names, frames: torch.Tensor) -> list[list[dict]]:
    """The whole request in precision ``p``: per frame, the valid faces as
    dicts with ``box``, ``prob``, ``landmarks``, ``name`` (the top-1 row's
    name), ``distance`` and ``embedding``."""
    d = mtcnn.detect(p, det_weights, spec, frames)
    boxes = clean_boxes(d["boxes"], spec.frame_hw)
    emb = embed_faces(p, embed_fn, frames, boxes, d["landmarks"], size)
    v, i = gallery.best(p, emb.reshape(-1, emb.shape[-1]))
    dist = torch.sqrt(torch.clamp(2.0 - 2.0 * v, min=0.0)).reshape(emb.shape[:2])
    i = i.reshape(emb.shape[:2])
    out = []
    for bi in range(frames.shape[0]):
        faces = []
        for fi in range(spec.max_faces):
            if not bool(d["valid"][bi, fi]):
                continue
            faces.append({"box": boxes[bi, fi].tolist(), "prob": float(d["probs"][bi, fi]),
                          "landmarks": d["landmarks"][bi, fi].tolist(),
                          "name": names(int(i[bi, fi])), "distance": float(dist[bi, fi]),
                          "embedding": emb[bi, fi].cpu().numpy()})
        out.append(faces)
    return out
