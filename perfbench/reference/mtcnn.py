"""Plain MTCNN cascade (Zhang et al. 2016) as the serve cells run it: the
bilinear pyramid, P-Net with its top-k per level, per-scale and
cross-scale NMS, R-Net on 24 px crops, O-Net on 48 px crops, whole-over-part
demotion and the final min-mode NMS. Static shapes, as the served cascade:
``k_pnet`` candidates a level, ``k_rnet`` proposals, ``max_faces`` slots.

Plain f32 functions over the nets' parameters in their JAX layout (the
``outputs/detector/*.npz`` trees: conv kernels HWIO, dense kernels
[in, out], PReLU ``alpha``), with no kernel, no capture and no rounding to
a lower precision unless ``Precision`` asks for it. NMS is the greedy rule
stated as a fixed point ("a box survives iff no surviving higher-scored box
overlaps it past the threshold", ties to the lower index), iterated until
it holds."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from perfbench.reference.precision import Precision

FACTOR = 0.709
K_LARGE = 4
PART_RATIO = 2.5
RNET_CROP_SCALE = 0.6
RNET_NMS_IOU = 0.7
THRESHOLDS = (0.6, 0.7, 0.7)


@dataclass(frozen=True)
class DetectorSpec:
    frame_hw: tuple[int, int]
    min_face_size: int
    max_faces: int
    k_pnet: int
    k_rnet: int


# ---------------------------------------------------------------- the nets
def _conv(p: Precision, x, layer, stride=1):
    w = layer["kernel"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    return p.conv2d(x, w, layer["bias"], stride)


def _prelu(x, layer):
    a = layer["alpha"].float()
    a = a.view(1, -1, *([1] * (x.ndim - 2))) if x.ndim > 2 else a
    return torch.where(x >= 0, x, a * x)


def _dense(p: Precision, x, layer):
    return p.matmul(x, layer["kernel"]) + layer["bias"].float()


def _pool_ceil(x, window, stride):
    h, w = x.shape[2], x.shape[3]
    ph = (-(h - window) % stride) if h > window else (window - h)
    pw = (-(w - window) % stride) if w > window else (window - w)
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def _flat_nhwc(x):
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def pnet(p: Precision, w, x_nhwc):
    x = x_nhwc.permute(0, 3, 1, 2)
    x = _pool_ceil(_prelu(_conv(p, x, w["conv1"]), w["prelu1"]), 2, 2)
    x = _prelu(_conv(p, x, w["conv2"]), w["prelu2"])
    x = _prelu(_conv(p, x, w["conv3"]), w["prelu3"])
    probs = torch.softmax(_conv(p, x, w["conv4_1"]), dim=1)[:, 1]
    return probs, _conv(p, x, w["conv4_2"]).permute(0, 2, 3, 1)


def rnet(p: Precision, w, x_nhwc):
    x = x_nhwc.permute(0, 3, 1, 2)
    x = _pool_ceil(_prelu(_conv(p, x, w["conv1"]), w["prelu1"]), 3, 2)
    x = _pool_ceil(_prelu(_conv(p, x, w["conv2"]), w["prelu2"]), 3, 2)
    x = _prelu(_conv(p, x, w["conv3"]), w["prelu3"])
    x = _prelu(_dense(p, _flat_nhwc(x), w["dense4"]), w["prelu4"])
    return torch.softmax(_dense(p, x, w["dense5_1"]), dim=-1)[:, 1], _dense(p, x, w["dense5_2"])


def onet(p: Precision, w, x_nhwc):
    x = x_nhwc.permute(0, 3, 1, 2)
    x = _pool_ceil(_prelu(_conv(p, x, w["conv1"]), w["prelu1"]), 3, 2)
    x = _pool_ceil(_prelu(_conv(p, x, w["conv2"]), w["prelu2"]), 3, 2)
    x = _pool_ceil(_prelu(_conv(p, x, w["conv3"]), w["prelu3"]), 2, 2)
    x = _prelu(_conv(p, x, w["conv4"]), w["prelu4"])
    x = _prelu(_dense(p, _flat_nhwc(x), w["dense5"]), w["prelu5"])
    probs = torch.softmax(_dense(p, x, w["dense6_1"]), dim=-1)[:, 1]
    return probs, _dense(p, x, w["dense6_2"]), _dense(p, x, w["dense6_3"])


# ------------------------------------------------------------- resampling
def resize(x_nhwc, out_hw):
    """Antialiased bilinear resize (as ``jax.image.resize`` downsamples)."""
    y = F.interpolate(x_nhwc.permute(0, 3, 1, 2).float(), size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def bilinear_weights(starts, scales, out_size, in_size):
    """[..., out, in]: row p samples the input at starts + scales * p,
    edge-clamped, by linear interpolation."""
    pos = starts[..., None] + scales[..., None] * torch.arange(out_size, device=starts.device)
    pos = pos.clamp(0.0, in_size - 1.0)
    s = torch.arange(in_size, dtype=torch.float32, device=starts.device)
    return torch.clamp(1.0 - (pos[..., None] - s).abs(), min=0.0)


def crop_resize(p: Precision, images, boxes, out_size):
    """images [B, H, W, C], boxes [B, N, 4] -> [B, N, out, out, C]: each box
    resampled to out x out by separable bilinear weights."""
    b, h, w, c = images.shape
    n = boxes.shape[1]
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    wy = bilinear_weights(y1, torch.clamp(y2 - y1, min=1.0) / out_size, out_size, h)
    wx = bilinear_weights(x1, torch.clamp(x2 - x1, min=1.0) / out_size, out_size, w)
    t = p.matmul(wy, images.float().reshape(b, 1, h, w * c))  # [B, N, P, W*C]
    t = t.reshape(b * n, out_size, w, c).permute(0, 2, 1, 3).reshape(b * n, w, out_size * c)
    out = p.matmul(wx.reshape(b * n, out_size, w), t)
    return out.reshape(b, n, out_size, out_size, c).permute(0, 1, 3, 2, 4)


# -------------------------------------------------------------------- NMS
def topk_stable(x, k):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def overlap(boxes, mode):
    x1 = torch.maximum(boxes[..., :, None, 0], boxes[..., None, :, 0])
    y1 = torch.maximum(boxes[..., :, None, 1], boxes[..., None, :, 1])
    x2 = torch.minimum(boxes[..., :, None, 2], boxes[..., None, :, 2])
    y2 = torch.minimum(boxes[..., :, None, 3], boxes[..., None, :, 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    a = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
         * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))
    ai, aj = a[..., :, None], a[..., None, :]
    if mode == "min":
        denom = torch.minimum(ai, aj)
    elif mode == "dupmin":  # min-area overlap for similar sizes, IoU otherwise
        a_min = torch.minimum(ai, aj)
        similar = torch.maximum(ai, aj) <= 2.5 * torch.clamp(a_min, min=1e-12)
        denom = torch.where(similar, a_min, ai + aj - inter)
    else:
        denom = ai + aj - inter
    return inter / torch.clamp(denom, min=1e-12)


def nms(boxes, scores, valid, threshold, mode, max_out):
    """Greedy NMS over [..., N] -> (boxes, scores, kept, index), sorted by
    score and truncated to ``max_out`` slots."""
    n = boxes.shape[-2]
    neg = float("-inf")
    s0 = torch.where(valid, scores.float(), neg)
    idx = torch.arange(n, device=boxes.device)
    sj, si = s0[..., None, :], s0[..., :, None]
    dominates = (sj > si) | ((sj == si) & (idx[None, :] < idx[:, None]))
    sup = (overlap(boxes.float(), mode) > threshold) & dominates & valid[..., None, :]
    keep0 = valid & (s0 > neg)
    keep = keep0
    for _ in range(n):
        new = keep0 & ~torch.any(sup & keep[..., None, :], dim=-1)
        if bool(torch.equal(new, keep)):
            break
        keep = new
    m = min(max_out, n)
    top_s, order = topk_stable(torch.where(keep, s0, neg), m)
    kept = top_s > neg
    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, boxes.shape[-1]))
    s = torch.where(kept, torch.gather(scores.float(), -1, order), 0.0)
    return b, s, kept, torch.where(kept, order, 0)


# ---------------------------------------------------------------- cascade
def pyramid_scales(h, w, min_face, factor=FACTOR, oversize_levels=1):
    m = 12.0 / min_face
    min_side = min(h, w) * m
    scales = []
    while min_side >= 12.0:
        scales.append(m)
        m *= factor
        min_side *= factor
    for _ in range(oversize_levels):
        scales.append(m)
        m *= factor
    return scales


def _regress(boxes, reg):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return torch.stack([boxes[..., 0] + reg[..., 0] * w, boxes[..., 1] + reg[..., 1] * h,
                        boxes[..., 2] + reg[..., 2] * w, boxes[..., 3] + reg[..., 3] * h], -1)


def _pad(bx, sc, vl, n):
    pad = n - bx.shape[1]
    if pad > 0:
        bx, sc, vl = F.pad(bx, (0, 0, 0, pad)), F.pad(sc, (0, pad)), F.pad(vl, (0, pad))
    return bx, sc, vl


def _square(boxes):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    side = torch.maximum(w, h)
    cx = (boxes[..., 0] + boxes[..., 2]) / 2
    cy = (boxes[..., 1] + boxes[..., 3]) / 2
    return torch.stack([cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2], dim=-1)


def _demote_nested(boxes, scores, valid, part_ratio):
    """A box nested in a larger valid one loses 1.0 of its score, unless the
    outer box holds two disjoint, far smaller valid boxes (a collage)."""
    ix1 = torch.maximum(boxes[:, :, None, 0], boxes[:, None, :, 0])
    iy1 = torch.maximum(boxes[:, :, None, 1], boxes[:, None, :, 1])
    ix2 = torch.minimum(boxes[:, :, None, 2], boxes[:, None, :, 2])
    iy2 = torch.minimum(boxes[:, :, None, 3], boxes[:, None, :, 3])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))
    cont = inter / torch.clamp(area[:, :, None], min=1e-12)
    nested = ((cont >= 0.8) & (area[:, None, :] >= part_ratio * area[:, :, None])
              & valid[:, None, :])
    iou = inter / torch.clamp(area[:, :, None] + area[:, None, :] - inter, min=1e-12)
    nv = nested & valid[:, :, None] & (area[:, None, :] >= 8.0 * area[:, :, None])
    collage = torch.any(nv[:, :, None, :] & nv[:, None, :, :] & (iou < 0.3)[:, :, :, None],
                        dim=(1, 2))
    return torch.where(torch.any(nested & ~collage[:, None, :], dim=2), scores - 1.0, scores)


def normalize(frames):
    """0..255 frames -> (x - 127.5) / 128, underexposed frames (std < 24)
    first stretched to std 48, mean 110."""
    x = frames.float()
    m = x.mean(dim=(1, 2, 3), keepdim=True)
    s = torch.sqrt(torch.clamp((x * x).mean(dim=(1, 2, 3), keepdim=True) - m * m, min=0.0))
    dark = s < 24.0
    gain = 48.0 / torch.clamp(s, min=4.0)
    m_eff = torch.where(dark, m + (127.5 - 110.0) / gain, 127.5)
    g_eff = torch.where(dark, gain, 1.0) * (1.0 / 128.0)
    return torch.clamp((x - m_eff) * g_eff, -127.5 / 128.0, 127.5 / 128.0)


def detect(p: Precision, weights: dict, spec: DetectorSpec, frames: torch.Tensor) -> dict:
    """frames [B, H, W, 3] 0..255 -> {boxes [B, F, 4], probs [B, F],
    landmarks [B, F, 5, 2], valid [B, F]}."""
    h, w = spec.frame_hw
    b = frames.shape[0]
    xn = normalize(frames)
    scales = pyramid_scales(h, w, spec.min_face_size)
    rnet_keep = min(2 * spec.max_faces, max(spec.k_rnet, spec.max_faces))
    rnet_scale = min(max(RNET_CROP_SCALE, 24.0 / spec.min_face_size), 1.0)
    coarse = 0.5 * min(h, w)
    # stage 1: P-Net over the pyramid
    all_b, all_s, all_v = [], [], []
    for scale in scales:
        p_thr = 0.0 if 12.0 / scale >= coarse else THRESHOLDS[0]
        sh, sw = max(int(math.ceil(h * scale)), 12), max(int(math.ceil(w * scale)), 12)
        prob, reg = pnet(p, weights["pnet"], resize(xn, (sh, sw)))
        bh, bw = prob.shape[1], prob.shape[2]
        k = min(spec.k_pnet, bh * bw)
        top_p, top_i = topk_stable(prob.reshape(b, -1), k)
        iy = torch.div(top_i, bw, rounding_mode="floor").float()
        ix = (top_i % bw).float()
        boxes = torch.stack([ix * 2.0 / scale, iy * 2.0 / scale, (ix * 2.0 + 12.0) / scale,
                             (iy * 2.0 + 12.0) / scale], dim=-1)
        boxes = _regress(boxes, torch.gather(reg.reshape(b, -1, 4), 1,
                                             top_i[..., None].expand(b, k, 4)))
        boxes, top_p, valid = _pad(boxes, top_p, top_p > p_thr, spec.k_pnet)
        all_b.append(boxes)
        all_s.append(top_p)
        all_v.append(valid)
    k_keep = min(spec.k_pnet, spec.k_rnet)
    bx, sc, vl, _ = nms(torch.stack(all_b, 1), torch.stack(all_s, 1), torch.stack(all_v, 1),
                        0.5, "union", k_keep)
    n_coarse = sum(1 for s in scales if 12.0 / s >= coarse)
    if 0 < n_coarse < len(scales):  # coarse levels keep their own slots
        q = max(1, min(k_keep, (spec.k_rnet // 8) // n_coarse))
        while q > 1 and q * n_coarse > spec.k_rnet - 1:
            q -= 1
        k_c = min(q * n_coarse, spec.k_rnet - 1)
        cb = bx[:, -n_coarse:, :q].reshape(b, -1, 4)[:, :k_c]
        cs = sc[:, -n_coarse:, :q].reshape(b, -1)[:, :k_c]
        cv = vl[:, -n_coarse:, :q].reshape(b, -1)[:, :k_c]
        fb, fs, fv, _ = nms(bx[:, :-n_coarse].reshape(b, -1, 4), sc[:, :-n_coarse].reshape(b, -1),
                            vl[:, :-n_coarse].reshape(b, -1), 0.7, "dupmin", spec.k_rnet - k_c)
        fb, fs, fv = _pad(fb, fs, fv, spec.k_rnet - k_c)
        boxes, valid = torch.cat([fb, cb], 1), torch.cat([fv, cv], 1)
    else:
        boxes, scores, valid, _ = nms(bx.reshape(b, -1, 4), sc.reshape(b, -1), vl.reshape(b, -1),
                                      0.7, "dupmin", spec.k_rnet)
        boxes, _, valid = _pad(boxes, scores, valid, spec.k_rnet)
    boxes = _square(boxes)
    # stage 2: R-Net on 24 px crops of a reduced copy of the frame
    if rnet_scale != 1.0:
        rh, rw = int(round(h * rnet_scale)), int(round(w * rnet_scale))
        scale4 = torch.tensor([rw / w, rh / h, rw / w, rh / h], device=boxes.device)
        crops = crop_resize(p, resize(xn, (rh, rw)), boxes * scale4, 24)
    else:
        crops = crop_resize(p, xn, boxes, 24)
    rp, rreg = rnet(p, weights["rnet"], crops.reshape(-1, 24, 24, 3))
    rp = rp.reshape(b, spec.k_rnet)
    rboxes = _regress(boxes, rreg.reshape(b, spec.k_rnet, 4))
    fb, fs, fv, _ = nms(rboxes, rp, valid & (rp > THRESHOLDS[1]), RNET_NMS_IOU, "union", rnet_keep)
    fb, fs, fv = _pad(fb, fs, fv, rnet_keep)
    side = torch.maximum(rboxes[..., 2] - rboxes[..., 0], rboxes[..., 3] - rboxes[..., 1])
    large = valid & (rp > 0.0) & (side >= 0.5 * min(h, w))
    lb, _, lv, _ = nms(rboxes, rp, large, 0.7, "union", K_LARGE)
    lb, _, lv = _pad(lb, lv.float(), lv, K_LARGE)
    boxes = _square(torch.cat([fb, lb], 1))
    valid = torch.cat([fv, lv], 1)
    # stage 3: O-Net on 48 px crops
    ns = rnet_keep + K_LARGE
    op, oreg, olmk = onet(p, weights["onet"], crop_resize(p, xn, boxes, 48).reshape(-1, 48, 48, 3))
    op, oreg, olmk = op.reshape(b, ns), oreg.reshape(b, ns, 4), olmk.reshape(b, ns, 10)
    valid = valid & (op > THRESHOLDS[2])
    bwd, bht = boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1]
    landmarks = torch.stack([boxes[..., 0:1] + olmk[..., 0:5] * bwd[..., None],
                             boxes[..., 1:2] + olmk[..., 5:10] * bht[..., None]], dim=-1)
    boxes = _regress(boxes, oreg)
    mf = spec.max_faces
    boxes, _, valid, idx = nms(boxes, _demote_nested(boxes, op, valid, PART_RATIO), valid, 0.7,
                               "min", mf)
    probs = torch.where(valid, torch.gather(op, 1, idx), 0.0)
    landmarks = torch.gather(landmarks, 1, idx[..., None, None].expand(b, mf, 5, 2))
    return {"boxes": boxes, "probs": probs, "landmarks": landmarks, "valid": valid}


def weights_from_npz(trees: dict, device) -> dict:
    """{net: {layer: {name: array}}} -> the same tree of f32 tensors."""
    return {net: {layer: {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                          for k, v in params.items()} for layer, params in tree.items()}
            for net, tree in trees.items()}
