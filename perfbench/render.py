"""The serve cells' frame renderer: a frozen copy of the port's
``facerec_torch/data/synthetic.py::face_frames`` and the helpers it calls
(numpy and PIL only), so that the traffic stays the same whatever the
program's own renderer becomes. ``face_frames(batch, frame_hw, faces, rng)``
gives the frames the port's renderer gives for the same generator state."""

from __future__ import annotations

import zlib

import numpy as np

def _identity_params(rng: np.random.Generator,
                     skin_lum_range: tuple[float, float] | None = None) -> dict:
    """``skin_lum_range``: opt-in WIDE skin-luminance draw. The default
    mapping in render_face_photo lands base luminance in [0.58, 1.0] —
    light-to-medium tones only. Detector training opts into (0.25, 1.0)
    (detect/train.py) so R/O-Net learn dark skin; bench.py and the embedder
    dataset builders (make_synthetic_arrays / write_synthetic_imagefolder)
    now default to the same wide draw (floors re-measured round 3)."""
    p = {
        "skin": rng.uniform(0.35, 0.85, size=3),
        "face_ax": rng.uniform(0.28, 0.38),
        "face_ay": rng.uniform(0.34, 0.45),
        "eye_dx": rng.uniform(0.10, 0.16),
        "eye_y": rng.uniform(-0.12, -0.05),
        "eye_r": rng.uniform(0.025, 0.05),
        "eye_col": rng.uniform(0.0, 0.45, size=3),
        "mouth_y": rng.uniform(0.12, 0.22),
        "mouth_w": rng.uniform(0.08, 0.18),
        "mouth_h": rng.uniform(0.015, 0.04),
        "hair_col": rng.uniform(0.0, 0.6, size=3),
        "hair_top": rng.uniform(-0.42, -0.3),
    }
    if skin_lum_range is not None:
        p["skin_lum"] = float(rng.uniform(*skin_lum_range))
    return p


def _soft_ellipse(u, v, cx, cy, rx, ry, soft=0.18):
    """Soft-edged ellipse mask in [0,1]; q<=1 inside, soft falloff outside."""
    q = ((u - cx) / max(rx, 1e-6)) ** 2 + ((v - cy) / max(ry, 1e-6)) ** 2
    return np.clip((1.0 + soft - q) / soft, 0.0, 1.0).astype(np.float32)


def _over(img, mask, color):
    return img * (1.0 - mask[..., None]) + np.asarray(color, np.float32) * mask[..., None]


def render_face_photo(
    params: dict, size: int, jitter_rng: np.random.Generator | None = None,
    rot_deg: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Render a shaded face; returns (float img in [0,1] [S,S,3], alpha [S,S])."""
    rng = jitter_rng or np.random.default_rng(0)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    u0 = xs / size - 0.5
    v0 = ys / size - 0.5
    c, s = np.cos(np.deg2rad(rot_deg)), np.sin(np.deg2rad(rot_deg))
    # face-local coords (inverse rotation so the face appears rotated by +rot)
    u = c * u0 + s * v0
    v = -s * u0 + c * v0

    ax, ay = params["face_ax"], params["face_ay"]
    # plausible warm skin tone (R >= G >= B): identity controls the luminance
    # and adds a small per-channel cast
    raw = np.asarray(params["skin"], np.float32)
    base = float(raw.mean()) * 0.85 + 0.28
    if params.get("skin_lum") is not None:  # opt-in wide draw (_identity_params)
        base = float(params["skin_lum"])
    skin = np.asarray([base * 1.10, base * 0.84, base * 0.68], np.float32)
    skin = np.clip(skin + (raw - raw.mean()) * 0.15, 0.05, 1.0)

    # natural hair color: dark..brown..blond axis from the identity's raw
    # hair luminance, small cast from the raw channels
    hraw = np.asarray(params["hair_col"], np.float32)
    hl = float(hraw.mean())
    params = dict(params)
    params["hair_col"] = np.clip(
        np.asarray([hl * 1.05, hl * 0.8, hl * 0.55], np.float32) + (hraw - hl) * 0.1, 0.02, 1.0)
    eraw = np.asarray(params["eye_col"], np.float32)
    el = float(eraw.mean())
    # iris: dark brown to blue-grey
    params["eye_col"] = np.clip(
        np.asarray([el * 0.8, el * 0.75, el * 0.9], np.float32) + (eraw - el) * 0.2, 0.03, 0.6)

    # egg-shaped silhouette: the face narrows toward the chin
    taper = 1.0 - 0.16 * np.clip(v / ay, 0.0, 1.0)
    face_a = _soft_ellipse(u / taper, v, 0.0, 0.0, ax, ay, soft=0.10)
    # lambertian-ish shading + radial falloff toward the silhouette
    ld = rng.uniform(-1.0, 1.0, 2)
    ld = ld / max(np.linalg.norm(ld), 1e-6)
    strength = rng.uniform(0.18, 0.40)
    radial = (u / (ax * taper)) ** 2 + (v / ay) ** 2
    shade = 1.0 + strength * (ld[0] * u / ax + ld[1] * v / ay) - 0.22 * np.clip(radial, 0, 1.4) ** 2
    shade = np.clip(shade, 0.4, 1.55)[..., None].astype(np.float32)

    img = np.zeros((size, size, 3), np.float32)
    # neck below the chin + ears at the face sides (context real portraits
    # always have; drawn first so the face overlaps them)
    neck = _soft_ellipse(u, v, 0.0, ay * 1.25, ax * 0.42, ay * 0.5, 0.2)
    img = _over(img, neck, skin * 0.9)
    ears = np.zeros_like(neck)
    for sx_ in (-1.0, 1.0):
        ears = np.maximum(ears, _soft_ellipse(u, v, sx_ * ax * 0.98, params["eye_y"] + 0.06,
                                              ax * 0.16, ay * 0.16, 0.3))
    img = _over(img, ears, skin * 0.95)
    img = _over(img, face_a, skin)
    img *= shade
    context_a = np.maximum(neck, ears)

    # low-frequency skin blotchiness (real skin is not constant-color): smooth
    # multiplicative noise confined to the face
    blotch = rng.normal(0, 1, (max(size // 12, 2), max(size // 12, 2)))
    blotch = np.kron(blotch, np.ones((size // blotch.shape[0] + 1,) * 2))[:size, :size]
    from PIL import Image as _PILImage, ImageFilter as _PILFilter

    bl = _PILImage.fromarray(((blotch - blotch.min()) / (np.ptp(blotch) + 1e-6) * 255).astype(np.uint8))
    blotch = np.asarray(bl.filter(_PILFilter.GaussianBlur(size / 16)), np.float32) / 255 - 0.5
    img *= (1.0 + rng.uniform(0.03, 0.10) * blotch * face_a)[..., None]

    edx, ey, er = params["eye_dx"], params["eye_y"], params["eye_r"]
    brow_col = np.asarray(params["hair_col"], np.float32) * 0.55
    # real webcam eyes are often squinted/shadowed with little visible sclera
    # (the reference's gallery JPEGs all have dark, narrow eyes) — make both
    # random so the detector cannot key on a bright-sclera synthetic cue
    open_f = rng.uniform(0.5, 1.0)
    sclera_vis = rng.uniform(0.0, 1.0) ** 1.5
    sclera_col = np.asarray([0.78, 0.75, 0.72], np.float32) * rng.uniform(0.8, 1.05)
    for sx_ in (-1.0, 1.0):
        # eyebrow
        brow = _soft_ellipse(u, v, sx_ * edx, ey - er * 2.4, er * 1.9, er * 0.55, 0.5) * face_a
        img = _over(img, brow * 0.8, brow_col)
        # eyelid shadow band above the eye
        lid = _soft_ellipse(u, v, sx_ * edx, ey - er * 1.2, er * 1.7, er * 0.6, 0.6) * face_a
        img *= (1.0 - 0.16 * lid)[..., None]
        # sclera (variable visibility), iris, pupil — squint flattens all three
        sclera = _soft_ellipse(u, v, sx_ * edx, ey, er * 1.5, er * 0.95 * open_f, 0.35) * face_a
        img = _over(img, sclera * sclera_vis, sclera_col)
        iris = _soft_ellipse(u, v, sx_ * edx, ey, er * 0.72, er * 0.72 * open_f, 0.4) * face_a
        img = _over(img, iris, np.asarray(params["eye_col"], np.float32))
        pupil = _soft_ellipse(u, v, sx_ * edx, ey, er * 0.32, er * 0.32 * open_f, 0.6) * face_a
        img = _over(img, pupil, np.asarray([0.04, 0.03, 0.03]))
    # nose: subtle ridge + nostril dots
    my, mw, mh = params["mouth_y"], params["mouth_w"], params["mouth_h"]
    nose_y = (ey + my) / 2 + 0.02
    nose_m = np.exp(-((u / 0.05) ** 2)) * np.exp(-(((v - nose_y) / 0.10) ** 2))
    img *= (1.0 - 0.12 * nose_m[..., None] * face_a[..., None])
    for sx_ in (-1.0, 1.0):
        nost = _soft_ellipse(u, v, sx_ * 0.022, my - 0.065, 0.013, 0.010, 0.8) * face_a
        img = _over(img, nost * 0.6, skin * 0.45)
    # lips: two soft bands with a darker seam; saturation is random (many real
    # faces have near-skin-tone lips — the constant red band was a cue)
    lip_sat = rng.uniform(0.25, 1.0)
    lip_col = np.clip(skin * (1.0 + (np.asarray([1.15, 0.62, 0.62]) - 1.0) * lip_sat), 0, 1)
    lips = _soft_ellipse(u, v, 0.0, my, mw, mh * 1.7, 0.3) * face_a
    img = _over(img, lips, lip_col)
    seam = _soft_ellipse(u, v, 0.0, my, mw * 0.92, mh * 0.45, 0.6) * face_a
    img = _over(img, seam * 0.85, lip_col * 0.55)
    # stubble / beard: darken the jaw region with noise texture (p~0.35).
    # Wide-appearance identities (skin_lum opt-in) extend the strength to
    # full-beard darkening (0.55); the default stays stubble-only (0.35) so
    # distributions with measured baselines (bench frames) are untouched.
    if rng.uniform() < 0.35:
        beard_hi = 0.55 if params.get("skin_lum") is not None else 0.35
        jaw = _soft_ellipse(u, v, 0.0, ay * 0.55, ax * 0.85, ay * 0.55, 0.35) * face_a
        jaw = jaw * np.clip((v - my + 0.06) / 0.08, 0, 1)  # below the lip line
        grain = rng.uniform(0.6, 1.0, (size, size)).astype(np.float32)
        img *= (1.0 - rng.uniform(0.12, beard_hi) * jaw * grain)[..., None]

    # hair: style drawn from the identity (cap / full ring around the face /
    # short-or-bald), top at hair_top
    # crc32, not hash(): str hashes change with PYTHONHASHSEED, which made
    # the rendered frames differ from one process to the next
    style = params.get("hair_style",
                       zlib.crc32(str(round(float(params["hair_top"]), 6)).encode()) % 3)
    cut_v = ey - er * 3.2
    hair_col = np.asarray(params["hair_col"], np.float32)
    if style == 2:  # short / receding: thin rim above the forehead
        rim = _soft_ellipse(u / taper, v, 0.0, 0.0, ax * 1.02, ay * 1.02, 0.08)
        band = np.clip((cut_v - v) / 0.03 + 0.5, 0, 1) * np.clip((v - params["hair_top"]) / 0.02 + 0.5, 0, 1)
        hair_a = (rim * band * 0.85).astype(np.float32)
    elif style == 1:  # full hair: ring around the upper face down to the ears
        ring_out = _soft_ellipse(u, v, 0.0, -0.02, ax * 1.22, ay * 1.12, 0.10)
        below = np.clip((params["eye_y"] + 0.16 - v) / 0.05 + 0.5, 0, 1)
        inner = _soft_ellipse(u / taper, v, 0.0, 0.0, ax * 0.92, ay * 0.92, 0.10)
        hair_a = (ring_out * below * (1 - inner * np.clip((v - cut_v) / -0.04 + 0.5, 0, 1) * 0)).astype(np.float32)
        hair_a = np.maximum(hair_a * (1 - (face_a * (v > cut_v))), 0)
        # keep the facial region clear below the brow line
        hair_a = hair_a * (1 - face_a * np.clip((v - cut_v) / 0.03 + 0.5, 0, 1))
    else:  # cap (beret-like)
        h_cy = (params["hair_top"] + cut_v) / 2
        h_ry = max((cut_v - params["hair_top"]) / 2, 0.02) * 1.08
        hair_core = _soft_ellipse(u, v, 0.0, h_cy, ax * 1.10, h_ry, 0.12)
        hair_cut = np.clip((cut_v - v) / 0.04 + 0.5, 0.0, 1.0)
        hair_a = (hair_core * hair_cut).astype(np.float32)
    # fringe: soft hair lobes dipping into the forehead (curly/unkempt hair —
    # every male portrait in the reference gallery has one); appearance-only,
    # stays above the brow line so landmarks/box ground truth are unchanged
    if rng.uniform() < 0.5:
        n_lobes = int(rng.integers(2, 6))
        brow_line = ey - er * 2.9
        for _ in range(n_lobes):
            lx = rng.uniform(-ax * 0.85, ax * 0.85)
            ly = rng.uniform(params["hair_top"], brow_line)
            lr = rng.uniform(0.05, 0.14)
            lobe = _soft_ellipse(u, v, lx, ly, lr, lr * rng.uniform(0.7, 1.4), 0.3)
            hair_a = np.maximum(hair_a, (lobe * np.clip((brow_line - v) / 0.03 + 0.5, 0, 1)).astype(np.float32))
    # strand texture: vertically-smeared multiplicative noise over the hair
    strands = rng.normal(0, 1, (max(size // 6, 2), max(size // 24, 1)))
    strands = np.kron(strands, np.ones((size // strands.shape[0] + 1, size // strands.shape[1] + 1)))[:size, :size]
    hair_tex = np.clip(1.0 + 0.22 * strands, 0.55, 1.45).astype(np.float32)
    img = _over(img, hair_a, hair_col * (np.clip(shade[..., 0], 0.6, 1.2) * hair_tex)[..., None])

    alpha = np.clip(np.maximum(np.maximum(face_a, hair_a), context_a * 0.95), 0.0, 1.0)
    # mild texture so regions aren't constant-color
    img += rng.normal(0, 0.015, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0), alpha


def face_frames(batch: int, frame_hw: tuple[int, int], faces_per_frame: int,
                rng: np.random.Generator) -> np.ndarray:
    """[batch, H, W, 3] float32 0..255 frames, each holding ``faces_per_frame``
    photo-style faces (wide skin-luminance draw, up to ±8° rotation) on a
    dark noise background, one face per grid cell (``bench.py:29-64``)."""
    h, w = frame_hw
    frames = rng.uniform(0, 80, size=(batch, h, w, 3)).astype(np.float32)
    cols = int(np.ceil(np.sqrt(faces_per_frame)))
    rows = int(np.ceil(faces_per_frame / cols))
    cell_h, cell_w = h // rows, w // cols
    for b in range(batch):
        for f in range(faces_per_frame):
            p = _identity_params(rng, skin_lum_range=(0.25, 1.0))
            size = int(rng.integers(64, min(cell_h, cell_w)))
            face, alpha = render_face_photo(p, size, jitter_rng=rng,
                                            rot_deg=float(rng.uniform(-8, 8)))
            r, c = divmod(f, cols)
            oy = r * cell_h + int(rng.integers(0, max(cell_h - size, 1)))
            ox = c * cell_w + int(rng.integers(0, max(cell_w - size, 1)))
            region = frames[b, oy:oy + size, ox:ox + size]
            a = alpha[..., None]
            frames[b, oy:oy + size, ox:ox + size] = a * face * 255.0 + (1 - a) * region
    return frames

