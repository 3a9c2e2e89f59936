"""MTCNN face-detection cascade, P-Net / R-Net / O-Net (counterpart of
``facerec_tpu/detect/mtcnn.py``).

Static shapes as in the JAX version: fixed pyramid levels, ``k_pnet``
candidates per level, ``k_rnet`` proposals into R-Net, masked NMS and
``max_faces`` output slots. Public tensors are NHWC. Differences from the
JAX version that keep the results equal:

  * the P-Net top-k is exact with ties to the lower index (the JAX version
    uses ``approx_max_k`` on the TPU, which is exact on the CPU);
  * R-Net and O-Net flatten their feature maps in NHWC order before the
    dense layers, as the Flax nets do;
  * pyramid resizes antialias, as ``jax.image.resize`` does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from facerec_torch import resolve_device
from facerec_torch.ops.gallery import topk_stable
from facerec_torch.ops.image import resize_bilinear
from facerec_torch.ops.nms import nms
from facerec_torch.ops.warp_fast import crop_resize_matmul_batched


def max_pool_ceil(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Max pool (NCHW) keeping partial windows: pad bottom/right with -inf
    (torch ``ceil_mode=True`` semantics)."""
    h, w = x.shape[2], x.shape[3]
    ph = (-(h - window) % stride) if h > window else (window - h)
    pw = (-(w - window) % stride) if w > window else (window - w)
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def _nchw(x_nhwc: torch.Tensor) -> torch.Tensor:
    return x_nhwc.permute(0, 3, 1, 2)


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class PNet(nn.Module):
    """Proposal net: fully convolutional, stride 2, 12x12 receptive field."""

    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 10, 3), nn.PReLU(10)
        self.conv2, self.prelu2 = nn.Conv2d(10, 16, 3), nn.PReLU(16)
        self.conv3, self.prelu3 = nn.Conv2d(16, 32, 3), nn.PReLU(32)
        self.conv4_1 = nn.Conv2d(32, 2, 1)
        self.conv4_2 = nn.Conv2d(32, 4, 1)

    def forward(self, x_nhwc: torch.Tensor):
        x = max_pool_ceil(self.prelu1(self.conv1(_nchw(x_nhwc))), 2, 2)
        x = self.prelu2(self.conv2(x))
        x = self.prelu3(self.conv3(x))
        probs = torch.softmax(self.conv4_1(x), dim=1)[:, 1]  # [B, h, w]
        reg = self.conv4_2(x).permute(0, 2, 3, 1)  # [B, h, w, 4]
        return probs, reg


class RNet(nn.Module):
    """Refine net: 24x24 -> (face prob, bbox regression)."""

    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 28, 3), nn.PReLU(28)
        self.conv2, self.prelu2 = nn.Conv2d(28, 48, 3), nn.PReLU(48)
        self.conv3, self.prelu3 = nn.Conv2d(48, 64, 2), nn.PReLU(64)
        self.dense4, self.prelu4 = nn.Linear(576, 128), nn.PReLU(128)
        self.dense5_1 = nn.Linear(128, 2)
        self.dense5_2 = nn.Linear(128, 4)

    def forward(self, x_nhwc: torch.Tensor):
        x = max_pool_ceil(self.prelu1(self.conv1(_nchw(x_nhwc))), 3, 2)
        x = max_pool_ceil(self.prelu2(self.conv2(x)), 3, 2)
        x = self.prelu3(self.conv3(x))
        x = self.prelu4(self.dense4(_flatten_nhwc(x)))
        return torch.softmax(self.dense5_1(x), dim=-1)[:, 1], self.dense5_2(x)


class ONet(nn.Module):
    """Output net: 48x48 -> (face prob, bbox regression, 5-point landmarks)."""

    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 32, 3), nn.PReLU(32)
        self.conv2, self.prelu2 = nn.Conv2d(32, 64, 3), nn.PReLU(64)
        self.conv3, self.prelu3 = nn.Conv2d(64, 64, 3), nn.PReLU(64)
        self.conv4, self.prelu4 = nn.Conv2d(64, 128, 2), nn.PReLU(128)
        self.dense5, self.prelu5 = nn.Linear(1152, 256), nn.PReLU(256)
        self.dense6_1 = nn.Linear(256, 2)
        self.dense6_2 = nn.Linear(256, 4)
        self.dense6_3 = nn.Linear(256, 10)

    def forward(self, x_nhwc: torch.Tensor):
        x = max_pool_ceil(self.prelu1(self.conv1(_nchw(x_nhwc))), 3, 2)
        x = max_pool_ceil(self.prelu2(self.conv2(x)), 3, 2)
        x = max_pool_ceil(self.prelu3(self.conv3(x)), 2, 2)
        x = self.prelu4(self.conv4(x))
        x = self.prelu5(self.dense5(_flatten_nhwc(x)))
        probs = torch.softmax(self.dense6_1(x), dim=-1)[:, 1]
        return probs, self.dense6_2(x), self.dense6_3(x)


def init_like_flax(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw a P-, R- or O-Net's parameters as Flax initialises the JAX nets:
    convolution and dense kernels LeCun-normal (truncated normal of
    variance 1 / fan_in), biases 0, PReLU slopes 0.25; in the order of the
    net's parameters, from a CPU ``generator``."""
    from facerec_torch.models.arcface import truncated_normal_

    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                truncated_normal_(m.weight, 1.0 / m.weight[0].numel(), generator)
                m.bias.zero_()
            elif isinstance(m, nn.PReLU):
                m.weight.fill_(0.25)
    return net


class Detections(NamedTuple):
    boxes: torch.Tensor  # [B, max_faces, 4] x1y1x2y2 (input pixels)
    probs: torch.Tensor  # [B, max_faces]
    landmarks: torch.Tensor  # [B, max_faces, 5, 2] (x, y)
    valid: torch.Tensor  # [B, max_faces] bool


def pyramid_scales(h: int, w: int, min_face_size: int, factor: float = 0.709,
                   oversize_levels: int = 1) -> list[float]:
    """Scales 12/min_face * factor^i until the min side drops below 12, plus
    ``oversize_levels`` coarser levels that propose boxes larger than the
    frame (close-up portraits)."""
    m = 12.0 / min_face_size
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


def _apply_regression(boxes: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return torch.stack([
        boxes[..., 0] + reg[..., 0] * w,
        boxes[..., 1] + reg[..., 1] * h,
        boxes[..., 2] + reg[..., 2] * w,
        boxes[..., 3] + reg[..., 3] * h,
    ], dim=-1)


def _pad_slots(bx, sc, vl, n_slots: int):
    """Pad [B, m, ...] NMS output to exactly ``n_slots`` slots."""
    pad = n_slots - bx.shape[1]
    if pad > 0:
        bx = F.pad(bx, (0, 0, 0, pad))
        sc = F.pad(sc, (0, pad))
        vl = F.pad(vl, (0, pad))
    return bx, sc, vl


def demote_nested(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                  part_ratio: float = 1.5) -> torch.Tensor:
    """Whole-over-part score demotion for the final min-mode NMS: a box
    nested in a larger valid box (containment >= 0.8, area ratio >=
    ``part_ratio``) loses 1.0, unless the outer box holds two or more
    mutually disjoint, far smaller (area ratio >= 8) valid boxes (a collage,
    not a face). Batched [B, N, 4] / [B, N]."""
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
    disj = iou < 0.3
    collage = torch.any(nv[:, :, None, :] & nv[:, None, :, :] & disj[:, :, :, None], dim=(1, 2))
    is_part = torch.any(nested & ~collage[:, None, :], dim=2)
    return torch.where(is_part, scores - 1.0, scores)


def _square(boxes: torch.Tensor) -> torch.Tensor:
    """rerec: expand to a square around the centre."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    side = torch.maximum(w, h)
    cx = (boxes[..., 0] + boxes[..., 2]) / 2
    cy = (boxes[..., 1] + boxes[..., 3]) / 2
    return torch.stack([cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2], dim=-1)


class MTCNN(nn.Module):
    """Batched ``detect(images) -> Detections`` at the JAX cascade's served
    settings (``facerec_tpu/detect/mtcnn.py`` gives the measurements behind
    each): pyramid factor 0.709 with one oversize level; coarse levels and
    the ``K_LARGE`` reserved O-Net slots ride on rank alone (thresholds 0);
    R-Net crops from a 0.6-scale frame; ``2 * max_faces`` fine R-Net
    survivors; 'dupmin' cross-scale NMS; whole-over-part demotion at area
    ratio 2.5; the low-light remap. Weights load with ``load_jax_params``."""

    FACTOR = 0.709
    K_LARGE = 4
    PART_RATIO = 2.5
    RNET_CROP_SCALE = 0.6
    RNET_NMS_IOU = 0.7
    CROSS_SCALE_NMS_MODE = "dupmin"

    def __init__(
        self,
        image_hw: tuple[int, int],
        min_face_size: int = 20,
        thresholds: tuple[float, float, float] = (0.6, 0.7, 0.7),
        max_faces: int = 16,
        k_pnet: int = 64,
        k_rnet: int = 64,
        dtype: torch.dtype = torch.float32,
        input_range: str = "auto",
        device: str | torch.device | None = None,
    ):
        """``input_range``: "255" or "1" pins the frames' pixel scale;
        "auto" infers it per call from the batch maximum."""
        super().__init__()
        self.device = resolve_device(device)
        if input_range not in ("auto", "255", "1"):
            raise ValueError(f"input_range must be auto/255/1, got {input_range!r}")
        self.image_hw = tuple(image_hw)
        self.thresholds = thresholds
        self.max_faces = max_faces
        self.k_pnet = k_pnet
        self.k_rnet = k_rnet
        self.rnet_keep = min(2 * max_faces, max(k_rnet, max_faces))
        self.input_range = input_range
        # min-size faces must still downsample into the 24 px R-Net crop
        self.rnet_crop_scale = min(max(self.RNET_CROP_SCALE, 24.0 / min_face_size), 1.0)
        self.scales = pyramid_scales(*self.image_hw, min_face_size, self.FACTOR)
        self.dtype = dtype
        self.pnet, self.rnet, self.onet = PNet(), RNet(), ONet()
        self.to(device=self.device, dtype=dtype).eval()

    def load_jax_params(self, params: dict) -> "MTCNN":
        """Load ``{"pnet", "rnet", "onet"}`` JAX parameter trees (as
        ``detect.weights.load_detector_params`` returns them)."""
        from facerec_torch.convert import from_jax

        for name in ("pnet", "rnet", "onet"):
            net = getattr(self, name)
            net.load_state_dict(from_jax(params[name], name))
        self.to(device=self.device, dtype=self.dtype)
        return self

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] frames -> the cascade's normalised compute-dtype
        tensor. Underexposed frames (pixel std < 24) are first stretched to
        std 48, mean 110; the remap folds into the normalising affine, so
        well-exposed frames get exactly (x - 127.5) / 128."""
        x = images.float()
        if self.input_range == "auto":
            x = torch.where(x.max() <= 2.0, x * 255.0, x)
        elif self.input_range == "1":
            x = x * 255.0
        m = x.mean(dim=(1, 2, 3), keepdim=True)
        s2 = (x * x).mean(dim=(1, 2, 3), keepdim=True)
        s = torch.sqrt(torch.clamp(s2 - m * m, min=0.0))
        dark = s < 24.0
        gain = 48.0 / torch.clamp(s, min=4.0)
        m_eff = torch.where(dark, m + (127.5 - 110.0) / gain, 127.5)
        g_eff = torch.where(dark, gain, 1.0) * (1.0 / 128.0)
        lo, hi = (0.0 - 127.5) / 128.0, (255.0 - 127.5) / 128.0
        return torch.clamp((x - m_eff) * g_eff, lo, hi).to(self.dtype)

    @torch.no_grad()
    def detect(self, images: torch.Tensor) -> Detections:
        """images: [B, H, W, 3] on the detector's device, pixel scale per
        ``input_range``."""
        h, w = images.shape[1], images.shape[2]
        if (h, w) != self.image_hw:
            raise ValueError(f"built for {self.image_hw}, got {(h, w)}")
        xn = self.normalize(images)
        boxes, _, valid = self.stage1(xn)
        return self._stages23(xn, boxes, valid)

    forward = detect

    def stage1(self, xn: torch.Tensor):
        """P-Net over the pyramid + per-scale and stratified cross-scale NMS.
        Returns squared candidates (boxes [B, k_rnet, 4], scores, valid)."""
        b = xn.shape[0]
        h, w = self.image_hw
        all_boxes, all_scores, all_valid = [], [], []
        coarse_side = 0.5 * min(h, w)
        xf = xn.float()  # every level resamples the frame in f32
        for scale in self.scales:
            p_thr = 0.0 if 12.0 / scale >= coarse_side else self.thresholds[0]
            sh, sw = max(int(math.ceil(h * scale)), 12), max(int(math.ceil(w * scale)), 12)
            prob, reg = self.pnet(resize_bilinear(xf, (sh, sw)).to(self.dtype))
            bh, bw = prob.shape[1], prob.shape[2]
            k = min(self.k_pnet, bh * bw)
            top_p, top_i = topk_stable(prob.reshape(b, -1), k)
            iy = torch.div(top_i, bw, rounding_mode="floor").float()
            ix = (top_i % bw).float()
            boxes = torch.stack([(ix * 2.0) / scale, (iy * 2.0) / scale,
                                 (ix * 2.0 + 12.0) / scale, (iy * 2.0 + 12.0) / scale], dim=-1)
            reg_k = torch.gather(reg.reshape(b, -1, 4), 1, top_i[..., None].expand(b, k, 4))
            boxes = _apply_regression(boxes, reg_k)
            valid = top_p > p_thr
            top_p = top_p.float()
            if k < self.k_pnet:
                boxes, top_p, valid = _pad_slots(boxes, top_p, valid, self.k_pnet)
            all_boxes.append(boxes)
            all_scores.append(top_p)
            all_valid.append(valid)
        k_keep = min(self.k_pnet, self.k_rnet)
        sb = torch.stack(all_boxes, dim=1)  # [B, S, k, 4]
        ss = torch.stack(all_scores, dim=1)
        sv = torch.stack(all_valid, dim=1)
        bx, sc, vl, _ = nms(sb, ss, sv, 0.5, "union", k_keep)
        n_coarse = sum(1 for s in self.scales if 12.0 / s >= 0.5 * min(h, w))
        if 0 < n_coarse < len(self.scales):
            q = max(1, min(k_keep, (self.k_rnet // 8) // n_coarse))
            while q > 1 and q * n_coarse > self.k_rnet - 1:
                q -= 1
            k_c = min(q * n_coarse, self.k_rnet - 1)
            cb2 = bx[:, -n_coarse:, :q].reshape(b, -1, 4)[:, :k_c]
            cs2 = sc[:, -n_coarse:, :q].reshape(b, -1)[:, :k_c]
            cv2 = vl[:, -n_coarse:, :q].reshape(b, -1)[:, :k_c]
            fb, fs, fv = bx[:, :-n_coarse], sc[:, :-n_coarse], vl[:, :-n_coarse]
            fb2, fs2, fv2, _ = nms(fb.reshape(b, -1, 4), fs.reshape(b, -1), fv.reshape(b, -1),
                                   0.7, self.CROSS_SCALE_NMS_MODE, self.k_rnet - k_c)
            fb2, fs2, fv2 = _pad_slots(fb2, fs2, fv2, self.k_rnet - k_c)
            boxes = torch.cat([fb2, cb2], dim=1)
            scores = torch.cat([fs2, cs2], dim=1)
            valid = torch.cat([fv2, cv2], dim=1)
        else:
            boxes, scores, valid, _ = nms(bx.reshape(b, -1, 4), sc.reshape(b, -1),
                                          vl.reshape(b, -1), 0.7, self.CROSS_SCALE_NMS_MODE,
                                          self.k_rnet)
            boxes, scores, valid = _pad_slots(boxes, scores, valid, self.k_rnet)
        return _square(boxes), scores, valid

    def rnet_crops(self, xn: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """24 px R-Net crops, resampled from a ``rnet_crop_scale`` copy of
        the frame."""
        h, w = self.image_hw
        if self.rnet_crop_scale != 1.0:
            rs = self.rnet_crop_scale
            rh, rw = int(round(h * rs)), int(round(w * rs))
            xh = resize_bilinear(xn.float(), (rh, rw))
            rscale = torch.tensor([rw / w, rh / h, rw / w, rh / h], device=boxes.device)
            return crop_resize_matmul_batched(xh, boxes * rscale, 24, out_dtype=self.dtype)
        return crop_resize_matmul_batched(xn, boxes, 24, out_dtype=self.dtype)

    def _stages23(self, xn: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor
                  ) -> Detections:
        b = xn.shape[0]
        h, w = self.image_hw
        mf = self.max_faces
        # ---- stage 2: R-Net ---------------------------------------------------
        crops = self.rnet_crops(xn, boxes)
        rp, rreg = self.rnet(crops.reshape(-1, 24, 24, 3))
        rp = rp.reshape(b, self.k_rnet)
        rreg = rreg.reshape(b, self.k_rnet, 4)
        rvalid = valid & (rp > self.thresholds[1])
        rboxes = _apply_regression(boxes, rreg)
        rk = self.rnet_keep
        fb, fs, fv, _ = nms(rboxes, rp, rvalid, self.RNET_NMS_IOU, "union", rk)
        fb, fs, fv = _pad_slots(fb, fs, fv, rk)
        # reserved slots for large survivors (full-face hypotheses on
        # close-up portraits), which R-Net ranks below facial parts
        side = torch.maximum(rboxes[..., 2] - rboxes[..., 0], rboxes[..., 3] - rboxes[..., 1])
        large = valid & (rp > 0.0) & (side >= 0.5 * min(h, w))
        lb, _, lv, _ = nms(rboxes, rp, large, 0.7, "union", self.K_LARGE)
        lb, _, lv = _pad_slots(lb, lv.float(), lv, self.K_LARGE)
        boxes = _square(torch.cat([fb, lb], dim=1))
        valid = torch.cat([fv, lv], dim=1)

        # ---- stage 3: O-Net ---------------------------------------------------
        ns = rk + self.K_LARGE
        crops = crop_resize_matmul_batched(xn, boxes, 48, out_dtype=self.dtype)
        op, oreg, olmk = self.onet(crops.reshape(-1, 48, 48, 3))
        op = op.reshape(b, ns)
        oreg = oreg.reshape(b, ns, 4)
        olmk = olmk.reshape(b, ns, 10)
        valid = valid & (op > self.thresholds[2])
        bwd = boxes[..., 2] - boxes[..., 0]
        bht = boxes[..., 3] - boxes[..., 1]
        lx = boxes[..., 0:1] + olmk[..., 0:5] * bwd[..., None]
        ly = boxes[..., 1:2] + olmk[..., 5:10] * bht[..., None]
        landmarks = torch.stack([lx, ly], dim=-1)  # [B, ns, 5, 2]
        boxes = _apply_regression(boxes, oreg)
        op_eff = demote_nested(boxes, op, valid, self.PART_RATIO)
        boxes, _, valid, idx = nms(boxes, op_eff, valid, 0.7, "min", mf)
        probs = torch.where(valid, torch.gather(op.float(), 1, idx), 0.0)
        landmarks = torch.gather(landmarks, 1, idx[..., None, None].expand(b, mf, 5, 2))
        return Detections(boxes=boxes, probs=probs, landmarks=landmarks, valid=valid)
