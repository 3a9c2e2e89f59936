"""MTCNN trainer on synthetic scenes (counterpart of
``facerec_tpu/detect/train.py``).

Synthetic face scenes with exact box and landmark ground truth
(``data/synthetic.py`` ``render_scene``) drive the classic MTCNN recipe
(Zhang et al. 2016): per-net sample mining into positives (IoU >= 0.65,
classification + box regression), parts (0.4 <= IoU < 0.65, regression
only) and negatives (IoU < 0.3, classification only); O-Net adds 5-point
landmark regression. Each net trains on its own with Adam under a cosine
decay to lr/10.

The mining is a numpy and PIL copy of the JAX package's, so one seed mines
the same samples bit for bit. The training set is uploaded to the device
once and each batch is gathered there by index; the indices come from
``np.random.default_rng(seed)`` in JAX's order, so both trainers see the
same batches. Weights are saved as JAX-layout ``.npz`` trees
(``detect/weights.py`` ``save_detector_params``) that either package loads:

    python -m facerec_torch.detect.train [--device cpu]            # all three nets
    python -m facerec_torch.detect.train finetune [OUT_DIR]        # R-Net and O-Net
    python -m facerec_torch.detect.train finetune-pnet [OUT_DIR]   # P-Net
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

from facerec_torch import resolve_device
from facerec_torch.config import OptimizerConfig, logger
from facerec_torch.convert import from_jax, to_jax
from facerec_torch.data.synthetic import _identity_params, render_scene
from facerec_torch.detect.mtcnn import ONet, PNet, RNet, init_like_flax
from facerec_torch.detect.weights import DEFAULT_DIR, save_detector_params
from facerec_torch.train.state import OptaxChain

NET_NAMES = {PNet: "pnet", RNet: "rnet", ONet: "onet"}


def _iou(box_a: np.ndarray, box_b: np.ndarray) -> float:
    x1 = max(box_a[0], box_b[0]); y1 = max(box_a[1], box_b[1])
    x2 = min(box_a[2], box_b[2]); y2 = min(box_a[3], box_b[3])
    inter = max(x2 - x1, 0) * max(y2 - y1, 0)
    aa = (box_a[2] - box_a[0]) * (box_a[3] - box_a[1])
    ab = (box_b[2] - box_b[0]) * (box_b[3] - box_b[1])
    return inter / max(aa + ab - inter, 1e-9)


def _crop(img: np.ndarray, box: np.ndarray, size: int) -> np.ndarray:
    """Crop with EDGE REPLICATION for out-of-frame boxes — matching the
    runtime crop (ops/warp_fast._bilinear_weights clips sample positions to
    the frame, i.e. replicates edges), so regression targets on edge-cut
    faces stay geometrically exact."""
    from PIL import Image

    x1, y1, x2, y2 = [int(round(v)) for v in box]
    h, w = img.shape[:2]
    pad_l, pad_t = max(-x1, 0), max(-y1, 0)
    pad_r, pad_b = max(x2 - w, 0), max(y2 - h, 0)
    if pad_l or pad_t or pad_r or pad_b:
        img = np.pad(img, ((pad_t, pad_b), (pad_l, pad_r), (0, 0)), mode="edge")
        x1 += pad_l; x2 += pad_l; y1 += pad_t; y2 += pad_t
    x2, y2 = max(x2, x1 + 1), max(y2, y1 + 1)
    patch = img[y1:y2, x1:x2]
    return np.asarray(Image.fromarray(patch).resize((size, size), Image.BILINEAR), np.uint8)


def _augment_crop(patch: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Per-crop photometric domain randomization (uint8 -> uint8): tint,
    gamma, contrast, low light, blur, noise. R-Net/O-Net see crops whose
    statistics vary independently of the scene — measured to be what closes
    the confidence gap on real photographs (P-Net generalized first; R/O-Net
    sat at 0.1-0.5 on real faces until crops were augmented)."""
    img = patch.astype(np.float32) / 255.0
    # Correlated "tiny dark JPEG source" mode: the degradations below fire
    # independently at 0.3-0.35 each, so their CO-occurrence — which is what
    # the hardest real gallery photo actually is (random3_00000003.jpg: a
    # 33x42 near-black low-quality JPEG upsampled 4.8x at serving, then
    # gain-4.2 re-exposed by lowlight_norm) — carries ~1% of training mass.
    # Committed R/O-Net score its full-face crop 0.007/0.02 while a human
    # reads eyes/nose/mouth from the same 24px crop. In this mode the full
    # stack fires together, in the real data-generating ORDER: darken ->
    # downscale -> JPEG at the TINY resolution (blocks get magnified by the
    # upsample, not stamped at patch scale) -> upscale -> re-expose.
    degraded = rng.uniform() < 0.25 and patch.shape[0] >= 24
    img = img * rng.uniform(0.85, 1.15, 3).astype(np.float32)
    if rng.uniform() < 0.4:  # strong warm/cool cast (indoor tungsten / blue
        # daylight: the reference JPEGs carry casts far beyond +-15%)
        t = rng.uniform(-0.35, 0.35)
        img = img * np.asarray([1 + t, 1.0, 1 - t], np.float32)
    img = np.clip(img, 0, 1) ** rng.uniform(0.6, 1.6)
    m = img.mean()
    img = np.clip((img - m) * rng.uniform(0.7, 1.3) + m, 0, 1)
    if degraded or rng.uniform() < 0.35:  # low light, down to near-black (the
        # reference gallery's darkest crop has mean luminance 0.15)
        img = img * (rng.uniform(0.08, 0.35) if degraded
                     else rng.uniform(0.08, 0.7))
    if (degraded or rng.uniform() < 0.35) and patch.shape[0] >= 24:
        # low source resolution: the gallery JPEGs are as small as 33x42 and
        # get upsampled to 160x160 at serving — simulate by down-up resample
        import io

        from PIL import Image

        f = rng.uniform(3.5, 6.5) if degraded else rng.uniform(2.0, 6.0)
        s = patch.shape[0]
        small = max(int(s / f), 4)
        pil = Image.fromarray((img * 255).astype(np.uint8))
        pil = pil.resize((small, small), Image.BILINEAR)
        if degraded:  # compress at the tiny resolution, like the source file
            buf = io.BytesIO()
            pil.save(buf, "JPEG", quality=int(rng.integers(18, 55)))
            buf.seek(0)
            pil = Image.open(buf)
        img = np.asarray(pil.resize((s, s), Image.BILINEAR), np.float32) / 255
    if not degraded and rng.uniform() < 0.3:
        # JPEG blocking/ringing (every reference photo is a low-quality JPEG)
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray((img * 255).astype(np.uint8)).save(
            buf, "JPEG", quality=int(rng.integers(25, 75)))
        buf.seek(0)
        img = np.asarray(Image.open(buf), np.float32) / 255
    if rng.uniform() < 0.3 and patch.shape[0] >= 24:
        from PIL import Image, ImageFilter

        pil = Image.fromarray((img * 255).astype(np.uint8))
        img = np.asarray(pil.filter(ImageFilter.GaussianBlur(rng.uniform(0.3, 1.0))),
                         np.float32) / 255
    img = np.clip(img + rng.normal(0, rng.uniform(0, 0.03), img.shape), 0, 1)
    # Serve-side exposure-remap appearance (detect/mtcnn.py lowlight_norm):
    # frames darker than per-frame std 24 are affinely stretched back to
    # ~std 48 / mean 110 BEFORE the cascade, so at serving the nets never
    # see raw near-black crops — they see re-exposed ones whose uint8
    # quantization / JPEG-block noise is amplified by the ~2-6x gain (the
    # one remaining uncovered gallery photo, random3_00000003.jpg, is a
    # 33x42 source at frame std 11.5 -> gain 4.2). Quantize first so the
    # banding is real, and jitter the target stats: the serve remap uses
    # FRAME statistics while a face crop inside it has its own.
    q = np.round(img * 255.0).astype(np.float32)
    if q.std() < 24.0 and rng.uniform() < 0.7:
        gain = rng.uniform(36.0, 60.0) / max(float(q.std()), 4.0)
        img = np.clip((q - q.mean()) * gain + rng.uniform(90.0, 130.0),
                      0.0, 255.0) / 255.0
    return (img * 255).astype(np.uint8)


def make_training_samples(
    n_scenes: int, size: int, seed: int = 0, with_landmarks: bool = False,
    canvas: int = 128, augment_p: float = 0.7, closeup_p: float = 0.35,
    subpart_n: int = 2, subpart_scale: tuple[float, float] = (0.2, 0.45),
    subpart_jitter: float = 0.15,
) -> dict[str, np.ndarray]:
    """Mine pos/part/neg patches from synthetic scenes.

    Returns arrays: image [N,size,size,3] f32 (MTCNN normalization applied),
    cls_label [N] (1 face / 0 nonface), cls_mask, reg_target [N,4], reg_mask,
    (lmk_target [N,10], lmk_mask when with_landmarks).
    """
    rng = np.random.default_rng(seed)
    imgs, cls_l, cls_m, reg_t, reg_m, lmk_t, lmk_m = [], [], [], [], [], [], []

    def add(patch, cls, cm, reg=(0, 0, 0, 0), rm=0.0, lmk=None):
        if augment_p and rng.uniform() < augment_p:
            patch = _augment_crop(patch, rng)
        imgs.append((patch.astype(np.float32) - 127.5) / 128.0)
        cls_l.append(cls)
        cls_m.append(cm)
        reg_t.append(reg)
        reg_m.append(rm)
        lmk_t.append(lmk if lmk is not None else np.zeros(10, np.float32))
        lmk_m.append(0.0 if lmk is None else 1.0)

    for _ in range(n_scenes):
        # closeup_p extreme close-up portraits (face 90-145% of the canvas,
        # cut at the frame boundary — the reference gallery JPEGs crop at
        # forehead AND chin), else the general distribution up to ~125%
        if rng.uniform() < closeup_p:
            fr = (int(canvas * 0.9), int(canvas * 1.45))
        else:
            fr = (32, int(canvas * 1.25))
        # wide-appearance identities: skin luminance 0.25-1.0 (the default
        # render distribution stops at 0.58 — light/medium tones only) and
        # full-beard jaw darkening. The one reference-gallery photo whose
        # full-face box every trained O-Net rejects is a dark-skinned
        # bearded subject the narrow distribution never renders.
        img, box, lmk = render_scene(
            rng, canvas=canvas, face_size_range=fr,
            params=_identity_params(rng, skin_lum_range=(0.25, 1.0)))
        bw, bh = box[2] - box[0], box[3] - box[1]
        side = max(bw, bh)
        cx, cy = (box[0] + box[2]) / 2, (box[1] + box[3]) / 2
        # positives + parts: jittered square crops around the face
        for _ in range(3):
            js = side * rng.uniform(0.85, 1.15)
            jx = cx + rng.uniform(-0.2, 0.2) * side
            jy = cy + rng.uniform(-0.2, 0.2) * side
            crop_box = np.asarray([jx - js / 2, jy - js / 2, jx + js / 2, jy + js / 2])
            iou = _iou(crop_box, box)
            if iou < 0.4:
                continue
            patch = _crop(img, crop_box, size)
            # regression targets: true box offsets relative to crop (normalized)
            reg = np.asarray([
                (box[0] - crop_box[0]) / js, (box[1] - crop_box[1]) / js,
                (box[2] - crop_box[2]) / js, (box[3] - crop_box[3]) / js,
            ], np.float32)
            if iou >= 0.65:
                lm = None
                if with_landmarks:
                    lm = np.concatenate([
                        (lmk[:, 0] - crop_box[0]) / js, (lmk[:, 1] - crop_box[1]) / js,
                    ]).astype(np.float32)
                add(patch, 1, 1.0, reg, 1.0, lm)
            else:  # part face: regression only
                add(patch, 0, 0.0, reg, 1.0)
        # interior-window positives for truncated faces: when the GT box
        # sticks out of the canvas, a serving-time window (P-Net's receptive
        # field lives INSIDE the frame) can never reach IoU 0.65 with the
        # unclipped box — so face-filling frames were never taught as
        # positives. Label such windows by IoU against the VISIBLE (clipped)
        # box — the standard truncated-object criterion — while the
        # regression target still points at the true box, teaching the nets
        # to extrapolate beyond the frame (the reference gallery's close-ups
        # crop at forehead AND chin).
        vis = np.asarray([max(box[0], 0.0), max(box[1], 0.0),
                          min(box[2], float(canvas)), min(box[3], float(canvas))])
        box_area = max(box[2] - box[0], 1e-6) * max(box[3] - box[1], 1e-6)
        vis_area = max(vis[2] - vis[0], 0.0) * max(vis[3] - vis[1], 0.0)
        if vis_area < 0.8 * box_area and vis_area > 0:
            for _ in range(2):
                ws = canvas * rng.uniform(0.75, 1.0)
                wx = rng.uniform(0, canvas - ws)
                wy = rng.uniform(0, canvas - ws)
                wbox = np.asarray([wx, wy, wx + ws, wy + ws])
                iou_v = _iou(wbox, vis)
                if iou_v < 0.4:
                    continue
                patch = _crop(img, wbox, size)
                reg = np.asarray([
                    (box[0] - wbox[0]) / ws, (box[1] - wbox[1]) / ws,
                    (box[2] - wbox[2]) / ws, (box[3] - wbox[3]) / ws,
                ], np.float32)
                if iou_v >= 0.65:
                    lm = None
                    if with_landmarks:
                        lm = np.concatenate([
                            (lmk[:, 0] - wbox[0]) / ws, (lmk[:, 1] - wbox[1]) / ws,
                        ]).astype(np.float32)
                    add(patch, 1, 1.0, reg, 1.0, lm)
                else:
                    add(patch, 0, 0.0, reg, 1.0)
        # sub-part hard negatives: small windows centered on a landmark (an
        # eye, the nose, a mouth corner). At serving these fine-scale windows
        # were the detector's dominant false-positive mode on real portraits
        # (a 0.91-confidence box on a nose); mining them as explicit
        # negatives teaches "a facial part is not a face".
        for _ in range(subpart_n):
            li = int(rng.integers(0, len(lmk)))
            ps = side * rng.uniform(*subpart_scale)
            px = lmk[li, 0] + rng.uniform(-subpart_jitter, subpart_jitter) * ps
            py = lmk[li, 1] + rng.uniform(-subpart_jitter, subpart_jitter) * ps
            pbox = np.asarray([px - ps / 2, py - ps / 2, px + ps / 2, py + ps / 2])
            if _iou(pbox, box) < 0.3:
                add(_crop(img, pbox, size), 0, 1.0)
        # negatives: random crops with low IoU
        tries = 0
        negs = 0
        while negs < 3 and tries < 20:
            tries += 1
            js = rng.uniform(12, canvas * 0.6)
            jx = rng.uniform(0, canvas - js)
            jy = rng.uniform(0, canvas - js)
            crop_box = np.asarray([jx, jy, jx + js, jy + js])
            if _iou(crop_box, box) < 0.3:
                add(_crop(img, crop_box, size), 0, 1.0)
                negs += 1
    out = {
        "image": np.stack(imgs), "cls_label": np.asarray(cls_l, np.int32),
        "cls_mask": np.asarray(cls_m, np.float32),
        "reg_target": np.asarray(reg_t, np.float32), "reg_mask": np.asarray(reg_m, np.float32),
    }
    if with_landmarks:
        out["lmk_target"] = np.stack(lmk_t)
        out["lmk_mask"] = np.asarray(lmk_m, np.float32)
    return out


def _net_loss(outputs, batch, with_landmarks: bool):
    """(loss, classification loss): masked binary cross-entropy on the face
    probability, plus half the masked squared box-regression error, plus the
    masked squared landmark error for O-Net. P-Net's maps are read at their
    first cell, the one a 12 px crop yields."""
    if with_landmarks:
        prob, reg, lmk = outputs
    else:
        prob, reg = outputs
        lmk = None
    if prob.dim() > 1:  # P-Net fully convolutional: the first cell
        prob = prob.reshape(prob.shape[0], -1)[:, 0]
        reg = reg.reshape(reg.shape[0], -1, 4)[:, 0]
    eps = 1e-7
    p = torch.clamp(prob, eps, 1 - eps)
    y = batch["cls_label"].float()
    cls = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    cls = torch.sum(cls * batch["cls_mask"]) / torch.clamp(torch.sum(batch["cls_mask"]), min=1)
    reg_l = torch.sum((reg - batch["reg_target"]) ** 2, dim=-1)
    reg_l = torch.sum(reg_l * batch["reg_mask"]) / torch.clamp(torch.sum(batch["reg_mask"]), min=1)
    loss = cls + 0.5 * reg_l
    if lmk is not None and "lmk_target" in batch:
        lmk_l = torch.sum((lmk - batch["lmk_target"]) ** 2, dim=-1)
        lmk_l = torch.sum(lmk_l * batch["lmk_mask"]) / torch.clamp(torch.sum(batch["lmk_mask"]),
                                                                   min=1)
        loss = loss + lmk_l
    return loss, cls


def cosine_lr(lr: float, steps: int, count: int, alpha: float = 0.1) -> float:
    """``optax.cosine_decay_schedule(lr, steps, alpha)`` at update ``count``
    (0 for the first), in f32 as optax computes it."""
    f = np.float32
    t = f(min(count, steps)) / f(steps)
    decay = f(0.5) * (f(1) + np.cos(f(np.pi) * t, dtype=np.float32))
    return float(f(lr) * ((f(1) - f(alpha)) * decay + f(alpha)))


def train_net(net: nn.Module, size: int, n_scenes: int, steps: int, batch_size: int = 256,
              lr: float = 1e-3, seed: int = 0, with_landmarks: bool = False,
              init_params: dict | None = None, sample_kwargs: dict | None = None,
              device: str | torch.device | None = None, stats: dict | None = None) -> dict:
    """Mine ``n_scenes`` scenes at ``size`` px and train ``net`` (a
    ``PNet``, ``RNet`` or ``ONet``) for ``steps`` Adam steps on ``device``
    (default: the CUDA card), from ``init_params`` (a Flax-layout tree) or a
    Flax-like draw seeded by ``seed``. Returns the trained Flax-layout tree.
    ``stats``, when given, receives ``mining_s``, ``samples``, ``step_ms``
    (CUDA events on the card, the host clock elsewhere) and the per-step
    ``losses`` and ``cls``."""
    dev = resolve_device(device)
    which = NET_NAMES[type(net)]
    t0 = time.perf_counter()
    data = make_training_samples(n_scenes, size, seed, with_landmarks, **(sample_kwargs or {}))
    mining_s = time.perf_counter() - t0
    n = len(data["image"])
    if init_params is not None:
        net.load_state_dict(from_jax(init_params, which))
    else:
        init_like_flax(net.cpu().float(), torch.Generator().manual_seed(seed))
    net.to(dev, torch.float32).train()
    params = list(net.parameters())
    opt = OptaxChain(net.named_parameters(),
                     OptimizerConfig(name="adam", learning_rate=lr, use_grad_clip=False))
    # the dataset lives on the device, uploaded once; batches are gathered
    # there by index (a per-step host batch would re-upload ~7 MB a step)
    data_dev = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    rng = np.random.default_rng(seed)
    history = []
    timer = _StepClock(dev)
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(0, n, batch_size)).to(dev)
        batch = {k: v[idx] for k, v in data_dev.items()}
        loss, cls = _net_loss(net(batch["image"]), batch, with_landmarks)
        grads = torch.autograd.grad(loss, params)
        opt.hyperparams["learning_rate"] = cosine_lr(lr, steps, i)
        opt.step(list(grads))
        if stats is not None:
            history.append(torch.stack([loss.detach(), cls.detach()]))
        if (i + 1) % max(steps // 5, 1) == 0:
            logger.info("  step %d/%d loss=%.4f cls=%.4f", i + 1, steps, float(loss.detach()),
                        float(cls.detach()))
    step_ms = timer.stop() / max(steps, 1)
    logger.info("trained %s in %.1fs (%d samples)", type(net).__name__,
                time.perf_counter() - t0, n)
    if stats is not None:
        h = torch.stack(history).cpu().numpy() if history else np.zeros((0, 2), np.float32)
        stats.update(mining_s=mining_s, samples=n, step_ms=step_ms,
                     losses=h[:, 0].tolist(), cls=h[:, 1].tolist())
    return to_jax(net.state_dict(), which)


class _StepClock:
    """Milliseconds from construction to ``stop``: CUDA events on a card
    (device time of the queued work), the host clock elsewhere."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            return self.start.elapsed_time(self.end)
        return (time.perf_counter() - self.t0) * 1000.0


def train_detector(out_dir: str | Path = DEFAULT_DIR, n_scenes: int = 2500, steps: int = 800,
                   seed: int = 0, device: str | torch.device | None = None) -> Path:
    """Train all three nets and save their weights to ``out_dir``."""
    logger.info("training P-Net...")
    pnet = train_net(PNet(), 12, n_scenes, steps, seed=seed, device=device)
    logger.info("training R-Net...")
    rnet = train_net(RNet(), 24, n_scenes, steps, seed=seed + 1, device=device)
    logger.info("training O-Net...")
    onet = train_net(ONet(), 48, n_scenes, steps, seed=seed + 2, with_landmarks=True,
                     device=device)
    path = save_detector_params({"pnet": pnet, "rnet": rnet, "onet": onet}, out_dir)
    logger.info("detector weights saved to %s", path)
    return path


def finetune_refiners(out_dir: str | Path, n_scenes: int = 1500, steps: int = 400,
                      lr: float = 2e-4, seed: int = 10, closeup_p: float = 0.5,
                      subpart_n: int = 4, device: str | torch.device | None = None) -> Path:
    """Fine-tune R-Net and O-Net from the committed weights on a
    close-up-heavy, part-negative-heavy mix (the part-versus-whole
    confusion on close-up portraits); P-Net is kept verbatim. Writes a
    candidate weight set to ``out_dir``, never the default path."""
    from facerec_torch.detect.weights import load_detector_params

    base = load_detector_params()
    sk = {"closeup_p": closeup_p, "subpart_n": subpart_n,
          "subpart_scale": (0.2, 0.55), "subpart_jitter": 0.35}
    logger.info("fine-tuning R-Net (closeup_p=%.2f subpart_n=%d)...", closeup_p, subpart_n)
    rnet = train_net(RNet(), 24, n_scenes, steps, lr=lr, seed=seed, init_params=base["rnet"],
                     sample_kwargs=sk, device=device)
    logger.info("fine-tuning O-Net...")
    onet = train_net(ONet(), 48, n_scenes, steps, lr=lr, seed=seed + 1, with_landmarks=True,
                     init_params=base["onet"], sample_kwargs=sk, device=device)
    path = save_detector_params({"pnet": base["pnet"], "rnet": rnet, "onet": onet}, out_dir)
    logger.info("candidate refiner weights saved to %s", path)
    return path


def finetune_pnet(out_dir: str | Path, n_scenes: int = 1500, steps: int = 400, lr: float = 2e-4,
                  seed: int = 30, device: str | torch.device | None = None) -> Path:
    """Fine-tune P-Net from the committed weights on the wide-appearance
    scenes; R-Net and O-Net are kept verbatim. Writes a candidate set to
    ``out_dir``."""
    from facerec_torch.detect.weights import load_detector_params

    base = load_detector_params()
    logger.info("fine-tuning P-Net (wide-appearance scenes)...")
    pnet = train_net(PNet(), 12, n_scenes, steps, lr=lr, seed=seed, init_params=base["pnet"],
                     device=device)
    path = save_detector_params({"pnet": pnet, "rnet": base["rnet"], "onet": base["onet"]},
                                out_dir)
    logger.info("candidate P-Net weights saved to %s", path)
    return path


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m facerec_torch.detect.train",
                                description="train the MTCNN detector on synthetic scenes")
    p.add_argument("mode", nargs="?", default="train", choices=("train", "finetune",
                                                                  "finetune-pnet"))
    p.add_argument("out_dir", nargs="?", default=None,
                   help="weights directory (default: outputs/detector for train, "
                        "outputs/detector_candidate[_p] for the fine-tunes)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.mode == "finetune":
        finetune_refiners(args.out_dir or "outputs/detector_candidate", device=args.device)
    elif args.mode == "finetune-pnet":
        finetune_pnet(args.out_dir or "outputs/detector_candidate_p", device=args.device)
    else:
        train_detector(args.out_dir or DEFAULT_DIR, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
