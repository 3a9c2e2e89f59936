"""IResNet-100 ArcFace served at 112 px on the card: align's two kernels at
the shapes that crop size gives them (the crop kernel's stage-A patches of
144 px, K2 at 144 -> 112), bit for bit against their plain routes, and
``FacePipeline`` with ``build_iresnet_embedder`` at ``embed_size`` 112, its
replayed step against the eager one and ``identify`` end to end.

These tests need an NVIDIA card and ``nvcc``; without them they skip. On the
card: ``python -m pytest tests/test_torch_iresnet_cuda.py -m cuda -q``."""

import math

import numpy as np
import pytest
import torch

from chip_smoke import K2_CASES, k2_case
from facerec_torch.ops.crop_kernel import crop_resize_kernel
from facerec_torch.ops.gallery import gallery_topk
from facerec_torch.ops.nms import nms_suppress
from facerec_torch.ops.warp_fast import _align_prep, crop_resize_matmul_batched, rotate_patches
from facerec_torch.ops.warp_kernel import rotate_patches_kernel

pytestmark = pytest.mark.cuda

HW = (480, 640)
CROP, PATCH = 112, 144  # the crop and align's stage-A patch (perfbench.flops.align_patch)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _pipeline(dev, rows: int = 64):
    """The benchmark's serve settings at 112 px: the committed detector, 8
    slots a frame, IResNet-100 from seed 1 in bf16, a gallery of ``rows``
    drawn rows, every face named by its nearest row."""
    from facerec_torch.config import ServeConfig
    from facerec_torch.detect.mtcnn import MTCNN
    from facerec_torch.detect.weights import load_detector_params
    from facerec_torch.models.iresnet import build_iresnet_embedder
    from facerec_torch.serve.pipeline import FacePipeline

    cfg = ServeConfig(max_faces=8, detection_threshold=0.0, recognition_threshold=2.0,
                      gallery_capacity=rows, top_k=5, embed_size=CROP)
    det = MTCNN(HW, min_face_size=40, max_faces=8, k_pnet=64, k_rnet=32, dtype=torch.bfloat16,
                input_range="255", device=dev)
    det.load_jax_params(load_detector_params())
    emb = build_iresnet_embedder(dtype=torch.bfloat16, seed=1, device=dev)
    pipe = FacePipeline(cfg, HW, det, emb, embed_dim=512, device=dev)
    gal = np.random.default_rng(2).normal(size=(rows, 512)).astype(np.float32)
    pipe.gallery.add_many([f"id{i}" for i in range(rows)], gal)
    return pipe


def _frames(seed: int = 0) -> np.ndarray:
    from facerec_torch.data.synthetic import face_frames

    return face_frames(48, HW, 8, np.random.default_rng(seed)).astype(np.uint8)


def test_align_kernels_at_112_on_a_serve_batch(dev, no_tf32):
    """The serve step's own calls at 112 px: the crop kernel's three calls
    (R-Net, O-Net, align's 48 x 8 patches of 144 px) against the matmul
    route, and K2 on those patches (384 x 144 -> 112) against the plain
    rotation, each bit for bit."""
    from facerec_torch.multichip import record_crops

    pipe = _pipeline(dev)
    x = pipe.upload(_frames())
    r = pipe.step(x)
    assert r.valid.sum().item() >= 100
    calls = record_crops(pipe, x, r)
    assert [(c[0].shape[1:3], c[1].shape[1], c[2]) for c in calls] == [
        ((288, 384), 32, 24), (HW, 20, 48), (HW, 8, PATCH)]
    for images, boxes, out, out_dtype in calls:
        got = crop_resize_kernel(images, boxes, out, out_dtype)
        assert torch.equal(got, crop_resize_matmul_batched(images, boxes, out, out_dtype))
    lmk = torch.where(r.valid[..., None, None], r.landmarks, pipe._default_lmk)
    patches, angle, centers = _align_prep(x.float(), r.boxes, lmk, CROP, 0.15)
    assert patches.shape == (48, 8, PATCH, PATCH, 3)
    flat = patches.reshape(-1, PATCH, PATCH, 3)
    before = rotate_patches_kernel.launches
    got = rotate_patches_kernel(flat, angle.reshape(-1), centers.reshape(-1, 2), CROP)
    want = rotate_patches(flat, angle.reshape(-1), centers.reshape(-1, 2), CROP)
    torch.cuda.synchronize()
    assert rotate_patches_kernel.launches == before + 1
    assert got.shape == (384, CROP, CROP, 3) and torch.equal(got, want)


@pytest.mark.parametrize("case", K2_CASES)
@pytest.mark.parametrize("n", [1, 5, 384])
def test_rotate_kernel_at_144_to_112(dev, case, n):
    """K2 at 112 px on drawn patches and its edge cases (``chip_smoke.k2_case``)."""
    g0 = torch.Generator(device=dev).manual_seed(n)
    patches = (torch.rand(n, PATCH, PATCH, 3, generator=g0, device=dev) * 255).to(torch.bfloat16)
    angles = (torch.rand(n, generator=g0, device=dev) * 2 - 1) * math.radians(15.0)
    centers = PATCH * (0.3 + 0.4 * torch.rand(n, 2, generator=g0, device=dev))
    angles, centers = k2_case(case, angles, centers, PATCH)
    got = rotate_patches_kernel(patches, angles, centers, CROP)
    assert torch.equal(got, rotate_patches(patches, angles, centers, CROP))


def test_identify_at_112_replays_the_eager_step(dev, no_tf32):
    """The replayed step equals the eager one, field for field, twice; a
    replay launches K1 once, K2 once, the NMS kernel 5 times and the crop
    kernel 3 times; ``identify`` answers every valid face from it."""
    pipe = _pipeline(dev)
    frames = _frames(1)
    x = pipe.upload(frames)
    eager = pipe.step(x)
    first = pipe.run_step(x)
    kernels = (gallery_topk, rotate_patches_kernel, nms_suppress, crop_resize_kernel)
    before = [k.launches for k in kernels]
    second = pipe.run_step(x)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 5, 3]
    assert len(pipe._graphs) == 1
    assert all(torch.equal(a, b) for a, b in zip(first, eager))
    assert all(torch.equal(a, b) for a, b in zip(second, eager))
    assert eager.embeddings.shape == (48, 8, 512) and eager.valid.sum().item() >= 100
    norms = eager.embeddings.float().norm(dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
    answers = pipe.identify(frames)
    assert len(answers) == 48
    assert sum(len(f) for f in answers) == eager.valid.sum().item()
    named = [face["name"] for f in answers for face in f]
    rows = eager.match_indices[..., 0][eager.valid].tolist()
    assert named == [f"id{i}" for i in rows]
