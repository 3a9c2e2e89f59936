"""The comparison that decides ``correct`` in a serve cell: what
``identify`` answered for a sample of the window's requests, judged by
the plain reference on the same frames, weights and gallery rows.

Numbers over the sampled requests' faces:

* ``det_iou_gap_q1`` (and, read but not compared, ``det_iou_gap_median``
  and ``det_iou_gap``): detect. Every face that either side holds at
  probability >= ``CONFIDENT`` must have a face on the other side; its gap
  is 1 - the best IoU it finds (1 where the other side has none). The
  first quartile of the gaps (the median, and the widest). The cascade's
  discrete choices (top-k, NMS, thresholds) flip under any rounding and
  move some boxes by a large step on every seed, so the wide end of the
  gaps says nothing of precision; the first quartile is the typical
  face's.
* ``det_unmatched_share`` (read, not compared): the share of those faces,
  on either side, that find no face on the other at IoU >=
  ``COUNTERPART_IOU``. The same flips that widen the widest gap set it, so
  sound runs read nearly as high as the control and no limit lies between.
* ``det_frames_blank``: frames whose answer holds no face while the
  reference holds a confident one (an exact count).

The rest are the widest over the faces:

* ``emb_gap``: align and embed. The L2 distance between a served unit
  embedding and the reference's, computed from the same frame at the
  served box and landmarks.
* ``match_gap``: match. How far the served top-1 row's f32 cosine with the
  served embedding lies below the best row's.
* ``dist_gap``: match. The served top-1 distance against the distance the
  served row's f32 cosine gives.

Align and embed are judged at the served boxes, and match on the served
embeddings: the reference follows the program's state there, and each
stage is judged by itself. Detect is judged against the reference's own
detections."""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import mtcnn
from perfbench.reference import serve as ref_serve
from perfbench.reference.match import Gallery
from perfbench.reference.precision import Precision

CONFIDENT = 0.9
COUNTERPART_IOU = 0.5
GAPS = ("det", "blank", "emb", "match", "dist")  # what a request's judgement keeps


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[n, 4] x [m, 4] -> [n, m]."""
    x1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    y1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    x2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    y2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / torch.clamp(area_a[:, None] + area_b[None, :] - inter, min=1e-12)


def _unmatched(boxes, probs, other) -> list[float]:
    """1 - the best IoU of each confident box against ``other``."""
    conf = [i for i, pr in enumerate(probs) if pr >= CONFIDENT]
    if not conf or len(other) == 0:
        return [1.0] * len(conf)
    iou = _iou(torch.tensor([boxes[i] for i in conf], dtype=torch.float64),
               torch.tensor(other, dtype=torch.float64))
    return (1.0 - iou.max(dim=1).values).tolist()


class ServeJudge:
    """The reference side of a serve cell's check."""

    def __init__(self, det_weights: dict, spec: mtcnn.DetectorSpec, embed_fn, size: int,
                 gallery: Gallery, row_of):
        self.p = Precision("f32")
        self.det_weights, self.spec, self.embed_fn, self.size = det_weights, spec, embed_fn, size
        self.gallery, self.row_of = gallery, row_of

    def judge(self, served: list[list[dict]], frames: torch.Tensor) -> dict[str, list[float]]:
        """``served``: what one request answered, per frame; ``frames``: its
        [B, H, W, 3] frames on the reference's device. Returns the per-face
        gaps (``GAPS``), which ``merge`` reduces to the numbers."""
        b = frames.shape[0]
        served = list(served) + [[] for _ in range(b - len(served))]  # frames left unanswered
        d = mtcnn.detect(self.p, self.det_weights, self.spec, frames.float())
        out: dict[str, list[float]] = {k: [] for k in GAPS}
        for bi in range(b):
            ref_boxes = [d["boxes"][bi, fi].tolist() for fi in range(self.spec.max_faces)
                         if bool(d["valid"][bi, fi])]
            ref_probs = [float(d["probs"][bi, fi]) for fi in range(self.spec.max_faces)
                         if bool(d["valid"][bi, fi])]
            boxes = [f["box"] for f in served[bi]]
            probs = [f["prob"] for f in served[bi]]
            out["det"] += (_unmatched(boxes, probs, ref_boxes)
                           + _unmatched(ref_boxes, ref_probs, boxes))
            out["blank"].append(float(not boxes and max(ref_probs, default=0.0) >= CONFIDENT))
        faces = [(bi, f) for bi in range(b) for f in served[bi]]
        if not faces:
            return out
        # align + embed at the served boxes: [B, Fmax] with unused slots at a dummy box
        fmax = max(len(s) for s in served)
        dev = frames.device
        boxes = torch.tensor([[0.0, 0.0, float(self.size), float(self.size)]], device=dev)
        boxes = boxes.repeat(b, fmax, 1)
        lmk = torch.zeros(b, fmax, 5, 2, device=dev)
        lmk[..., 0] = torch.tensor([40.0, 120.0, 80.0, 50.0, 110.0], device=dev)
        lmk[..., 1] = torch.tensor([60.0, 60.0, 90.0, 120.0, 120.0], device=dev)
        for bi in range(b):
            for fi, f in enumerate(served[bi]):
                boxes[bi, fi] = torch.tensor(f["box"], device=dev)
                lmk[bi, fi] = torch.tensor(f["landmarks"], device=dev).reshape(5, 2)
        emb_ref = ref_serve.embed_faces(self.p, self.embed_fn, frames.float(), boxes, lmk,
                                        self.size)
        ref_rows = torch.stack([emb_ref[bi, fi] for bi in range(b)
                                for fi in range(len(served[bi]))])
        emb = torch.stack([torch.as_tensor(f["embedding"], device=dev).float() for _, f in faces])
        out["emb"] = torch.linalg.vector_norm(emb - ref_rows, dim=1).tolist()
        # match, on the served embeddings
        rows = [self.row_of(f["name"]) for _, f in faces]
        if any(r is None for r in rows):
            out["match"] = out["dist"] = [math.inf]
            return out
        rows_t = torch.tensor(rows, device=dev)
        own = self.gallery.scores_of(emb, rows_t)
        best, _ = self.gallery.best(self.p, emb)
        out["match"] = (best - own).tolist()
        served_dist = torch.tensor([f["distance"] for _, f in faces], device=dev)
        ref_dist = torch.sqrt(torch.clamp(2.0 - 2.0 * own, min=0.0))
        out["dist"] = (served_dist - ref_dist).abs().tolist()
        return out


def failed_request() -> dict[str, list[float]]:
    """The gaps of a request that gave no answer."""
    return {k: [math.inf] for k in GAPS}


def merge(readings: list[dict[str, list[float]]]) -> dict[str, float]:
    """The numbers over several requests' gaps: the first quartile, the
    median and the widest detection gap and the share of faces without a
    counterpart, the widest of the others (NaN wins; no face reads 0)."""
    def pooled(k):
        return np.array([v for r in readings for v in r[k]], dtype=np.float64)

    def widest(x):
        return math.nan if np.isnan(x).any() else (float(x.max()) if len(x) else 0.0)

    det = pooled("det")
    bad = bool(np.isnan(det).any()) or not len(det)

    def q(x):
        return math.nan if bad else float(np.quantile(det, x))

    unmatched = math.nan if bad else float(np.mean(det > 1.0 - COUNTERPART_IOU))
    return {"det_iou_gap_q1": q(0.25), "det_unmatched_share": unmatched,
            "det_frames_blank": float(pooled("blank").sum()),
            "det_iou_gap_median": q(0.5),
            "det_iou_gap": widest(det), "emb_gap": widest(pooled("emb")),
            "match_gap": widest(pooled("match")), "dist_gap": widest(pooled("dist"))}
