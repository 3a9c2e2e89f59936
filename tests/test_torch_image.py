"""The port's exact gather warp (``facerec_torch/ops/image.py``) against the
JAX package's, function by function, and the serve step with
``precise_align=True`` against JAX's precise step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facerec_tpu.ops.image as J
from facerec_torch.config import ServeConfig
from facerec_torch.data.synthetic import _identity_params, face_frames, render_face
from facerec_torch.detect.mtcnn import MTCNN
from facerec_torch.detect.weights import load_detector_params
from facerec_torch.models.arcface import build_embedder
from facerec_torch.ops import image as T
from facerec_torch.ops.warp_fast import align_and_crop_fast_batched
from facerec_torch.serve.pipeline import FacePipeline
from facerec_tpu.config import ServeConfig as JaxServeConfig
from facerec_tpu.detect.mtcnn import MTCNN as JaxMTCNN
from facerec_tpu.detect.weights import load_detector_params as jax_load
from facerec_tpu.models import get_model
from facerec_tpu.serve.pipeline import FacePipeline as JaxFacePipeline

HW = (120, 160)
CFG = dict(max_faces=2, gallery_capacity=16, top_k=3, embed_size=64, detection_threshold=0.0,
           gallery_dtype="float32")
DET = dict(min_face_size=40, max_faces=2, k_pnet=16, k_rnet=8, input_range="255")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    boxes = np.stack([rng.uniform(2, 10, 4), rng.uniform(2, 8, 4), rng.uniform(20, 30, 4),
                      rng.uniform(16, 22, 4)], axis=-1).astype(f32)  # [4, 4] x1y1x2y2
    lmk = rng.uniform(4, 20, (4, 5, 2)).astype(f32)
    lmk[:, 1, 0] += 8.0  # the right eye right of the left one, tilted either way
    mats = np.concatenate([rng.normal(1.0, 0.15, (2, 2, 2)), rng.uniform(-4, 4, (2, 2, 1))],
                          axis=-1).astype(f32)
    return {
        # pixel values in [0, 1], as tests/test_ops.py's, so that 1e-5 is a
        # bar on the sampling and not on f32 rounding of 0..255 values
        "image": rng.uniform(0, 1, (24, 28, 3)).astype(f32),
        "images": rng.uniform(0, 1, (2, 24, 28, 3)).astype(f32),
        # coordinates inside, on and beyond every edge
        "x": rng.uniform(-3.0, 31.0, (9, 11)).astype(f32),
        "y": rng.uniform(-3.0, 27.0, (9, 11)).astype(f32),
        "mats": mats, "boxes": boxes, "lmk": lmk,
        "centers": rng.uniform(5, 20, (3, 2)).astype(f32),
        "angles": rng.uniform(-40, 40, 3).astype(f32),
        "fwd": rng.normal(0, 1, (3, 2, 3)).astype(f32) + np.eye(2, 3, dtype=f32),
        "fwd2": rng.normal(0, 1, (3, 2, 3)).astype(f32),
    }


# name -> (function name, argument keys; ints and tuples pass through as they are)
CASES = {
    "bilinear_sample": ("bilinear_sample", ("image", "x", "y")),
    "affine_warp": ("affine_warp", ("images", "mats", (10, 12))),
    "rotation_matrix": ("rotation_matrix", ("centers", "angles")),
    "invert_affine": ("invert_affine", ("fwd",)),
    "compose_affine": ("compose_affine", ("fwd", "fwd2")),
    "align_crop_matrix": ("align_crop_matrix", ("boxes", "lmk", 16)),
    "align_crop_matrix_no_landmarks": ("align_crop_matrix", ("boxes", None, 16)),
    "align_and_crop": ("align_and_crop", ("images", "boxes2", "lmk2", 16)),
    "crop_and_resize": ("crop_and_resize", ("images", "boxes2", (8, 10))),
    "align_and_crop_from": ("align_and_crop_from", ("image", "boxes", "lmk", 16)),
    "crop_and_resize_from": ("crop_and_resize_from", ("image", "boxes", (8, 10))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_exact_warp_matches_jax(case):
    fn, keys = CASES[case]
    data = _inputs()
    data["boxes2"], data["lmk2"] = data["boxes"][:2], data["lmk"][:2]

    def args(conv):
        return [conv(data[k]) if isinstance(k, str) else k for k in keys]

    want = np.asarray(getattr(J, fn)(*args(jnp.asarray)))
    got = getattr(T, fn)(*args(torch.from_numpy)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_affine_warp_identity():
    img = np.random.default_rng(0).uniform(size=(1, 16, 16, 3)).astype(np.float32)
    eye = torch.tensor([[[1.0, 0, 0], [0, 1, 0]]])
    out = T.affine_warp(torch.from_numpy(img), eye, (16, 16))
    np.testing.assert_allclose(out.numpy(), img, atol=1e-6)


def test_align_and_crop_levels_eyes():
    img = torch.zeros(1, 64, 64, 1)
    img[0, 20, 16] = 1.0  # left eye (x=16, y=20)
    img[0, 28, 48] = 1.0  # right eye, tilted down (x=48, y=28)
    lmk = torch.zeros(1, 5, 2)
    lmk[0, 0] = torch.tensor([16.0, 20.0])
    lmk[0, 1] = torch.tensor([48.0, 28.0])
    out = T.align_and_crop(img, torch.tensor([[8.0, 8.0, 56.0, 56.0]]), lmk, 48)[0, ..., 0]
    ys, _ = torch.nonzero(out > 0.2, as_tuple=True)
    assert ys.max() - ys.min() <= 2


def test_fast_align_matches_exact():
    """tests/test_ops.py's bars on the port: level eyes near-exact, tilted
    eyes above 30 dB PSNR."""
    frame = np.zeros((240, 320, 3), np.float32)
    face = render_face(_identity_params(np.random.default_rng(0)), 120, None)
    frame[60:180, 100:220] = face.astype(np.float32) / 255.0
    img = torch.from_numpy(frame)
    boxes = torch.tensor([[100.0, 60.0, 220.0, 180.0], [92.0, 52.0, 228.0, 188.0]])
    lmk = torch.zeros(2, 5, 2)
    lmk[:, :, 0] = torch.tensor([135.0, 185.0, 160.0, 140.0, 180.0])
    lmk[:, :, 1] = torch.tensor([105.0, 105.0, 130.0, 150.0, 150.0])
    for tilt, check in ((0.0, "level"), (8.0, "psnr")):
        lm = lmk.clone()
        lm[:, 1, 1] += tilt
        exact = T.align_and_crop_from(img, boxes, lm, 96)
        fast = align_and_crop_fast_batched(img[None], boxes[None], lm[None], 96)[0]
        if check == "level":
            assert (exact - fast).abs().mean() < 1e-3
        else:
            mse = float(((exact - fast) ** 2).mean())
            assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 30.0


def test_precise_serve_step_matches_jax():
    """FacePipeline(precise_align=True) against JAX's precise step on the
    same frames, weights and gallery, with the serve step's bars
    (tests/test_torch_pipeline.py)."""
    frames = face_frames(2, HW, 1, np.random.default_rng(0))
    model = get_model("arcface", num_classes=18)
    v = model.init({"params": jax.random.key(1), "dropout": jax.random.key(2)},
                   jnp.zeros((1, 64, 64, 3)), labels=jnp.zeros(1, jnp.int32), train=True)
    evars = {"params": v["params"], "batch_stats": v["batch_stats"]}
    jpipe = JaxFacePipeline(JaxServeConfig(**CFG), HW, JaxMTCNN(HW, **DET), jax_load(),
                            lambda ev, x: model.apply(ev, x, method="embed"),
                            embed_variables=evars, precise_align=True)
    tpipe = FacePipeline(ServeConfig(**CFG), HW,
                         MTCNN(HW, **DET, device="cpu").load_jax_params(load_detector_params()),
                         build_embedder(jax.tree_util.tree_map(np.asarray, evars),
                                        dtype=torch.float32, device="cpu"),
                         device="cpu", precise_align=True)
    probe = np.asarray(jpipe.process(frames).embeddings).reshape(-1, 512)
    rng = np.random.default_rng(7)
    gal = rng.normal(size=(10, 512)).astype(np.float32)
    gal[[2, 7, 4, 9]] = probe + 0.02 * rng.normal(size=probe.shape)
    names = [f"id{i}" for i in range(10)]
    jpipe.gallery.add_many(names, gal)
    tpipe.gallery.add_many(names, gal)

    ref = jax.device_get(jpipe.process(frames))
    got = tpipe.process(frames)
    valid = np.asarray(ref.valid)
    assert valid.sum() >= 2
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    e0, e1 = np.asarray(ref.embeddings)[valid], got.embeddings.numpy()[valid]
    assert np.all(np.sum(e0 * e1, axis=-1) > 0.999)
    np.testing.assert_array_equal(got.match_indices.numpy()[valid][:, 0],
                                  np.asarray(ref.match_indices)[valid][:, 0])
    np.testing.assert_allclose(got.match_scores.numpy()[valid],
                               np.asarray(ref.match_scores)[valid], atol=2e-3)
    np.testing.assert_array_equal(got.is_match.numpy(), np.asarray(ref.is_match))
    # the crops of the precise step are the exact warp's, in f32
    r = tpipe.detector.detect(torch.from_numpy(frames))
    crops = tpipe.align(torch.from_numpy(frames), r.boxes, r.landmarks)
    assert crops.dtype == torch.float32 and crops.shape == (2, 2, 64, 64, 3)
