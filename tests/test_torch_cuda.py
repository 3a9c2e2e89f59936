"""The port's CUDA kernels against their plain PyTorch versions, and the
port's trainer against its CPU run, on the card.

These tests need an NVIDIA card and ``nvcc``; without them they skip. On the
card: ``python -m pytest tests/test_torch_cuda.py -m cuda``."""

import math

import pytest
import torch

from chip_smoke import K2_CASES, TRAIN_STEP_RTOL, k2_case, nms_adversarial_rows, train_step_agrees
from facerec_torch.config import ArcFaceConfig, OptimizerConfig, SchedulerConfig, TrainConfig
from facerec_torch.data.synthetic import write_synthetic_imagefolder
from facerec_torch.models.arcface import build_embedder
from facerec_torch.ops import kernels
from facerec_torch.ops.arcface import cosine_logits
from facerec_torch.ops.crop_kernel import crop_resize_kernel
from facerec_torch.ops.gallery import (bf16_rows_per_split, bf16_splits, gallery_topk,
                                       gallery_topk_plain)
from facerec_torch.ops.nms import MAX_N, MODES, nms_suppress, nms_suppress_plain, overlap_matrix
from facerec_torch.ops.warp_fast import crop_resize_matmul_batched, rotate_patches
from facerec_torch.ops.warp_kernel import rotate_patches_kernel, rotate_patches_tiled
from facerec_torch.serve.pipeline import WARMUP_RUNS
from facerec_torch.train.engine import train_model
from test_torch_crop_kernel import KINDS, SITES, _boxes, _frames, _same, crop_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _unit(g0, rows, dim, dev):
    x = torch.randn(rows, dim, generator=g0, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def _assert_kernel_agrees(q, g, count, k, tol):
    """The kernel against the plain version fed the queries as the kernel
    rounds them (to the gallery dtype): indices exact except where the plain
    scores of the two rows lie within 1e-5 (summation order), at most 0.1%
    of the slots; values within 1e-5; and within ``tol`` of the plain
    version with f32 queries."""
    cnt = torch.tensor(count, dtype=torch.int32, device=q.device)
    before = kernels.launches()["gallery_topk"]
    v1, i1 = gallery_topk(q, g, cnt, k=k)
    v0, i0 = gallery_topk_plain(q.to(g.dtype), g, cnt, k=k)
    vf, _ = gallery_topk_plain(q, g, cnt, k=k)
    torch.cuda.synchronize()
    assert kernels.launches()["gallery_topk"] == before + 1
    nv = min(count, k)
    assert torch.equal(i1[:, nv:], i0[:, nv:]) and torch.equal(v1[:, nv:], v0[:, nv:])
    differ = i1[:, :nv] != i0[:, :nv]
    if differ.any():
        qr = q.to(g.dtype).float()
        s1 = (qr[:, None, :] * g[i1[:, :nv].long()].float()).sum(-1)
        assert (s1 - v0[:, :nv]).abs()[differ].max().item() <= 1e-5
    assert differ.sum().item() <= 1e-3 * max(differ.numel(), 1) or differ.sum().item() <= 1
    if nv:
        assert (v1 - v0)[:, :nv].abs().max().item() <= 1e-5
        assert (v1 - vf)[:, :nv].abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-3), (torch.float32, 1e-4)])
@pytest.mark.parametrize("rows,count", [(1024, 700), (1024, 3), (1024, 0), (5000, 4999)])
def test_gallery_topk_kernel_matches_plain(dev, dtype, tol, rows, count):
    g0 = torch.Generator(device=dev).manual_seed(rows + count)
    q = _unit(g0, 37, 256, dev)  # unit queries, as the embedder gives them
    g = _unit(g0, rows, 256, dev).to(dtype)
    _assert_kernel_agrees(q, g, count, 5, tol)


@pytest.mark.parametrize("k", [1, 5, 32])
@pytest.mark.parametrize("b,count", [(37, 127), (37, 128), (37, 129), (37, 257),
                                     (37, 132 * 128 - 1), (37, 132 * 128), (37, 132 * 128 + 1),
                                     (384, 44 * 128), (384, 44 * 128 + 1), (300, 20000)])
def test_gallery_topk_kernel_tile_and_split_edges(dev, k, b, count):
    """Counts at the edges of the bf16 kernel's 128-row tiles and of its
    splits (132 splits at 37 queries, 44 at 384), k from 1 to 32."""
    g0 = torch.Generator(device=dev).manual_seed(count + k)
    q = _unit(g0, b, 512, dev)
    g = _unit(g0, 20000, 512, dev).to(torch.bfloat16)
    _assert_kernel_agrees(q, g, count, k, 2e-3)


@pytest.mark.parametrize("dim", [16, 80, 576])
def test_gallery_topk_kernel_ragged_depth(dev, dim):
    """Widths that are multiples of 16 but not of the kernel's 64-deep
    stages (the tail is zero-filled), and one wider than 512."""
    g0 = torch.Generator(device=dev).manual_seed(dim)
    q = _unit(g0, 130, dim, dev)
    g = _unit(g0, 3000, dim, dev).to(torch.bfloat16)
    _assert_kernel_agrees(q, g, 2999, 5, 2e-3)


def test_gallery_topk_kernel_refuses_width(dev):
    g = torch.zeros(256, 40, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        gallery_topk(torch.zeros(3, 40, device=dev), g, 10)


def test_gallery_topk_kernel_split_boundary_ties(dev):
    """Identical rows on both sides of a split boundary and of a tile
    boundary score exactly alike; the lower row must come first."""
    g0 = torch.Generator(device=dev).manual_seed(7)
    rows, count, b = 131072, 100003, 384
    g = _unit(g0, rows, 512, dev).to(torch.bfloat16)
    q = _unit(g0, b, 512, dev)
    per = bf16_rows_per_split(count, bf16_splits(b, rows))
    pairs = [(per - 1, per), (3 * per - 1, 3 * per), (127, 128)]
    for n, (lo, hi) in enumerate(pairs):
        g[hi] = g[lo]
        q[n] = g[lo].float()
    _assert_kernel_agrees(q, g, count, 5, 2e-3)
    _, i1 = gallery_topk(q, g, torch.tensor(count, dtype=torch.int32, device=dev), k=5)
    for n, (lo, hi) in enumerate(pairs):
        assert i1[n, :2].tolist() == [lo, hi]


def test_rotate_kernel_matches_plain(dev):
    g0 = torch.Generator(device=dev).manual_seed(0)
    n, p, e = 12, 128, 96
    patches = (torch.rand(n, p, p, 3, generator=g0, device=dev) * 255).to(torch.bfloat16)
    angles = (torch.rand(n, generator=g0, device=dev) * 2 - 1) * math.radians(20.0)
    centers = p * (0.3 + 0.4 * torch.rand(n, 2, generator=g0, device=dev))
    before = kernels.launches()["shear_rotate"]
    got = rotate_patches_kernel(patches, angles, centers, e)
    ref = rotate_patches(patches, angles, centers, e)
    torch.cuda.synchronize()
    assert kernels.launches()["shear_rotate"] == before + 1
    assert torch.equal(got, ref), (got.float() - ref.float()).abs().max().item()


def _rotate_case(case, n, p, dev):
    """Patches at 0..255 and rotation inputs of one edge case
    (``chip_smoke.k2_case``) from random angles within +-15 degrees."""
    g0 = torch.Generator(device=dev).manual_seed(p + n)
    patches = (torch.rand(n, p, p, 3, generator=g0, device=dev) * 255).to(torch.bfloat16)
    angles = (torch.rand(n, generator=g0, device=dev) * 2 - 1) * math.radians(15.0)
    centers = p * (0.3 + 0.4 * torch.rand(n, 2, generator=g0, device=dev))
    return (patches, *k2_case(case, angles, centers, p))


@pytest.mark.parametrize("case", K2_CASES)
@pytest.mark.parametrize("n,p,e", [(5, 128, 96), (5, 208, 160), (3, 208, 208), (1, 208, 160),
                                   (4, 100, 50)])
def test_rotate_kernel_bit_exact(dev, case, n, p, e):
    """Bit for bit against the plain version, at both crop shapes and the
    edge cases, E == P, one patch, and a shape whose rows are not whole
    16-byte chunks (the kernel's element-wise copy and store paths)."""
    patches, angles, centers = _rotate_case(case, n, p, dev)
    before = kernels.launches()["shear_rotate"]
    got = rotate_patches_kernel(patches, angles, centers, e)
    ref = rotate_patches(patches, angles, centers, e)
    torch.cuda.synchronize()
    assert kernels.launches()["shear_rotate"] == before + 1
    assert got.shape == (n, e, e, 3)
    assert torch.equal(got, ref), (got.float() - ref.float()).abs().max().item()


@pytest.mark.parametrize("n,max_angle_deg", [(1, 15.0), (40, 15.0), (384, 15.0), (6, 30.0),
                                             (3, 40.0)])
def test_rotate_kernel_tilings(dev, n, max_angle_deg):
    """The tilings the launcher picks from the batch and the window: one to
    eight row ranges per patch, and, for the taller windows of wider angle
    limits, one block per SM with a deeper ring and shorter bands."""
    g0 = torch.Generator(device=dev).manual_seed(n)
    p, e = 208, 160
    patches = (torch.rand(n, p, p, 3, generator=g0, device=dev) * 255).to(torch.bfloat16)
    angles = (torch.rand(n, generator=g0, device=dev) * 2 - 1) * math.radians(max_angle_deg)
    centers = p * (0.3 + 0.4 * torch.rand(n, 2, generator=g0, device=dev))
    got = rotate_patches_kernel(patches, angles, centers, e, max_angle_deg)
    assert torch.equal(got, rotate_patches(patches, angles, centers, e, max_angle_deg))


@pytest.mark.parametrize("blocks_per_sm", [1, 2])
@pytest.mark.parametrize("segments", [1, 3, 8, 160])
def test_rotate_kernel_forced_tilings(dev, segments, blocks_per_sm):
    """Every tiling a caller may force gives the same bits: one to E row
    ranges per patch, at one or two blocks per SM."""
    patches, angles, centers = _rotate_case("random", 7, 208, dev)
    before = kernels.launches()["shear_rotate"]
    got = rotate_patches_tiled(patches, angles, centers, 160, segments=segments,
                               blocks_per_sm=blocks_per_sm)
    assert kernels.launches()["shear_rotate"] == before + 1
    assert torch.equal(got, rotate_patches(patches, angles, centers, 160))


@pytest.mark.parametrize("segments,blocks_per_sm", [(161, 0), (-1, 0), (0, 3)])
def test_rotate_kernel_refuses_tiling(dev, segments, blocks_per_sm):
    patches, angles, centers = _rotate_case("random", 2, 208, dev)
    with pytest.raises(RuntimeError, match="shear_rotate"):
        rotate_patches_tiled(patches, angles, centers, 160, segments=segments,
                             blocks_per_sm=blocks_per_sm)


@pytest.mark.parametrize("ch", [1, 4])
def test_rotate_kernel_other_channel_counts(dev, ch):
    """Grey and four-channel patches take the element-wise x pass."""
    g0 = torch.Generator(device=dev).manual_seed(ch)
    n, p, e = 4, 208, 160
    patches = (torch.rand(n, p, p, ch, generator=g0, device=dev) * 255).to(torch.bfloat16)
    angles = (torch.rand(n, generator=g0, device=dev) * 2 - 1) * math.radians(20.0)
    centers = p * (0.3 + 0.4 * torch.rand(n, 2, generator=g0, device=dev))
    got = rotate_patches_kernel(patches, angles, centers, e)
    assert torch.equal(got, rotate_patches(patches, angles, centers, e))


def test_rotate_kernel_refuses_channels(dev):
    with pytest.raises(ValueError, match="channels"):
        rotate_patches_kernel(torch.zeros(2, 64, 64, 5, device=dev), torch.zeros(2, device=dev),
                              torch.zeros(2, 2, device=dev), 48)


def test_rotate_kernel_empty_batch(dev):
    before = kernels.launches()["shear_rotate"]
    out = rotate_patches_kernel(torch.zeros(0, 208, 208, 3, device=dev), torch.zeros(0, device=dev),
                                torch.zeros(0, 2, device=dev), 160)
    assert out.shape == (0, 160, 160, 3) and kernels.launches()["shear_rotate"] == before


def _crop_agrees(images, boxes, out, out_dtype):
    """The crop kernel, one launch, against the matmul route on the card."""
    before = kernels.launches()["crop_resize"]
    got = crop_resize_kernel(images, boxes, out, out_dtype)
    ref = crop_resize_matmul_batched(images, boxes, out, out_dtype)
    torch.cuda.synchronize()
    assert kernels.launches()["crop_resize"] == before + 1
    assert got.dtype == ref.dtype == out_dtype and got.shape == ref.shape
    return _same(got.float(), ref.float())


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("site", SITES, ids=[s[0] for s in SITES])
def test_crop_kernel_matches_matmul_route(dev, site, kind, out_dtype):
    images, boxes, out = crop_case(site, kind)
    assert _crop_agrees(images.to(dev), boxes.to(dev), out, out_dtype)


@pytest.mark.parametrize("site,n", [(SITES[0], 32), (SITES[1], 20), (SITES[2], 8)],
                         ids=[s[0] for s in SITES])
def test_crop_kernel_at_the_serve_shapes(dev, site, n):
    """48 frames, the call's crops a frame, boxes of every kind mixed."""
    import numpy as np

    name, hw, dtype, out = site
    rng = np.random.default_rng(n)
    images = _frames(hw, dtype, name == "align", rng, b=48).to(dev)
    boxes = torch.cat([_boxes(k, hw, out, rng, b=48, n=n) for k in KINDS[:5]], dim=1)
    keep = torch.from_numpy(rng.permutation(boxes.shape[1])[:n])
    assert _crop_agrees(images, boxes[:, keep].to(dev), out, torch.bfloat16)


def test_crop_kernel_on_a_serve_batch(dev, no_tf32):
    """The three calls' own inputs from the eager serve step at the
    benchmark's settings (48 frames of 480 x 640, 8 faces each)."""
    import numpy as np

    from chip_smoke import build_pipeline
    from facerec_torch.data.synthetic import face_frames
    from facerec_torch.multichip import record_step

    pipe = build_pipeline(dev, (480, 640), 8, torch.bfloat16,
                          dict(gallery_capacity=64, top_k=5, embed_size=160))
    frames = face_frames(48, (480, 640), 8, np.random.default_rng(0)).astype(np.uint8)
    x = pipe.upload(frames)
    r = pipe.step(x)
    calls = [args for args, _ in record_step(pipe, x, r, ("crop_resize",))["crop_resize"]]
    assert r.valid.sum().item() >= 100
    assert [(c[0].shape[1:3], c[1].shape[1], c[2]) for c in calls] == [
        ((288, 384), 32, 24), ((480, 640), 20, 48), ((480, 640), 8, 208)]
    for images, boxes, out, out_dtype in calls:
        assert _crop_agrees(images, boxes, out, out_dtype)


@pytest.mark.parametrize("embedder", ["arcface", "facenet"])
def test_replayed_step_matches_the_matmul_route(dev, no_tf32, monkeypatch, embedder):
    """The replayed serve step at the benchmark's settings, packed result
    and embeddings, equal to the same step with the matmul crops."""
    import numpy as np

    from chip_smoke import build_pipeline
    from facerec_torch.data.synthetic import face_frames
    from facerec_torch.detect import mtcnn
    from facerec_torch.ops import crop_kernel

    frames = face_frames(48, (480, 640), 8, np.random.default_rng(1)).astype(np.uint8)
    gal = np.random.default_rng(2).normal(size=(64, 512)).astype(np.float32)

    def run():
        pipe = build_pipeline(dev, (480, 640), 8, torch.bfloat16,
                              dict(gallery_capacity=64, top_k=5, embed_size=160),
                              embedder=embedder)
        pipe.gallery.add_many([f"id{i}" for i in range(64)], gal)
        pipe.process_demo(frames)  # the capture, after its warm-up runs
        before = kernels.launches()["crop_resize"]
        packed, emb = pipe.process_demo(frames)
        return packed, emb.cpu(), kernels.launches()["crop_resize"] - before

    packed, emb, launched = run()

    def matmul_route(images, boxes, out_size, out_dtype=torch.float32):
        return crop_resize_matmul_batched(images, boxes, out_size, out_dtype)

    monkeypatch.setattr(mtcnn, "crop_resize_kernel", matmul_route)
    monkeypatch.setattr(crop_kernel, "crop_resize_kernel", matmul_route)
    ref_packed, ref_emb, ref_launched = run()
    assert (launched, ref_launched) == (3, 0)
    assert (packed[..., 0] > 0).sum() >= 100
    assert np.array_equal(packed, ref_packed) and torch.equal(emb, ref_emb)


def test_crop_kernel_refuses(dev):
    img = torch.zeros(2, 30, 40, 3, device=dev)
    boxes = torch.zeros(2, 4, 4, device=dev)
    with pytest.raises(ValueError, match="channels"):
        crop_resize_kernel(torch.zeros(2, 30, 40, 5, device=dev), boxes, 16)
    with pytest.raises(TypeError):
        crop_resize_kernel(img.to(torch.uint8), boxes, 16)
    with pytest.raises(TypeError):
        crop_resize_kernel(img, boxes, 16, torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        crop_resize_kernel(img.permute(0, 2, 1, 3), boxes, 16)
    with pytest.raises(ValueError):
        crop_resize_kernel(img, boxes.cpu(), 16)
    with pytest.raises(ValueError, match="16-byte"):  # 5 px of 3 channels
        crop_resize_kernel(img, boxes, 5, torch.float32)
    with pytest.raises(ValueError, match="16-byte"):  # 10 px of 2 channels
        crop_resize_kernel(img[..., :2].contiguous(), boxes, 10, torch.bfloat16)


@pytest.mark.parametrize("b,n", [(2, 0), (0, 3)])
def test_crop_kernel_empty_batch(dev, b, n):
    before = kernels.launches()["crop_resize"]
    got = crop_resize_kernel(torch.zeros(b, 30, 40, 3, device=dev),
                             torch.zeros(b, n, 4, device=dev), 16, torch.bfloat16)
    assert got.shape == (b, n, 16, 16, 3) and kernels.launches()["crop_resize"] == before


@pytest.mark.parametrize("ch,out", [(1, 24), (2, 24), (4, 48), (1, 8)])
def test_crop_kernel_other_channels(dev, ch, out):
    """Channel counts besides 3, down to one 16-byte vector a row."""
    import numpy as np

    rng = np.random.default_rng(ch)
    images = torch.from_numpy(rng.uniform(0, 255, (2, 60, 80, ch)).astype(np.float32)).to(dev)
    boxes = _boxes("straddling", (60, 80), out, rng).to(dev)
    for out_dtype in (torch.float32, torch.bfloat16):
        assert _crop_agrees(images, boxes, out, out_dtype)


@pytest.fixture
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def test_train_step_on_the_card_matches_the_cpu(dev, no_tf32):
    """chip_smoke's check: one f32 arcface step, dropout 0, loss and
    grad_norm within 1e-3 relative of the CPU's."""
    res = train_step_agrees(dev)
    assert res["loss"]["rel"] <= TRAIN_STEP_RTOL and res["grad_norm"]["rel"] <= TRAIN_STEP_RTOL


def test_cosine_product_refuses_tf32(dev):
    """The margin head's cosine product is full f32: with TF32 matrix
    products on it raises instead of flipping the process-wide flag."""
    x, w = torch.randn(4, 8, device=dev), torch.randn(3, 8, device=dev)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            cosine_logits(x, w)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        assert cosine_logits(x, w).shape == (4, 3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_train_model_on_the_card(dev, tmp_path):
    """A short bf16 arcface run of ``train_model`` on the card writes its
    artifacts, and its final checkpoint serves on the card."""
    root = write_synthetic_imagefolder(tmp_path / "ds", num_classes=4, per_class=9, size=64, seed=7)
    cfg = TrainConfig(model_type="arcface", batch_size=8, epochs=2, image_size=64, seed=0,
                      early_stopping=False, checkpoint_every=1,
                      arcface=ArcFaceConfig(margin=0.3, scale=16.0, two_phase=False, warmup_epochs=5),
                      optimizer=OptimizerConfig(name="adamw", amsgrad=True, learning_rate=5e-4),
                      scheduler=SchedulerConfig(name="warmup_cosine", warmup_epochs=1))
    out = train_model(cfg, root, checkpoints_root=tmp_path / "ck", model_name="m", device=dev)
    assert len(out["history"]) == 2 and all(math.isfinite(r["train_loss"]) for r in out["history"])
    assert out["state"].step == 2 * 4 and next(out["model"].parameters()).is_cuda
    model_dir = tmp_path / "ck" / "m"
    assert (model_dir / "final").exists() and (model_dir / "epoch_1").exists()
    emb = build_embedder(checkpoint=model_dir / "final", device=dev)
    got = emb.embed(torch.rand(3, 64, 64, 3, device=dev) * 255)
    assert got.shape == (3, 512) and torch.isfinite(got).all()


def _tiny_pipeline(dev, precise_align=False):
    """96 x 96 frames, the committed detector weights, a narrow ArcFace at
    32 px crops, f32, TF32 off by the caller."""
    from facerec_torch.config import ServeConfig
    from facerec_torch.detect.mtcnn import MTCNN
    from facerec_torch.detect.weights import load_detector_params
    from facerec_torch.serve.pipeline import FacePipeline

    cfg = ServeConfig(max_faces=4, gallery_capacity=128, top_k=3, embed_size=32,
                      detection_threshold=0.0, recognition_threshold=10.0)
    det = MTCNN((96, 96), min_face_size=24, max_faces=4, k_pnet=16, k_rnet=8, device=dev)
    det.load_jax_params(load_detector_params())
    emb = build_embedder(width=16, dtype=torch.float32, seed=1, device=dev)
    pipe = FacePipeline(cfg, (96, 96), det, emb, device=dev, precise_align=precise_align)
    pipe.gallery.add_many(["a", "b", "c"], torch.randn(3, 512, generator=torch.Generator()
                                                       .manual_seed(3)).numpy())
    return pipe


def _demo_frames():
    import numpy as np

    from facerec_torch.serve.app import synthetic_frame_source

    src = synthetic_frame_source((96, 96))
    return np.stack([src(), src()])


def test_precise_step_on_the_card_matches_the_cpu(dev, no_tf32):
    """FacePipeline(precise_align=True): the exact warp launches K1 and not
    K2, and agrees with the CPU step (same valid slots, cosine > 0.999,
    same top-1)."""
    frames = _demo_frames()
    card, cpu = _tiny_pipeline(dev, True), _tiny_pipeline(torch.device("cpu"), True)
    card.process(frames)  # the capture, after its warm-up runs
    k1, k2 = kernels.launches()["gallery_topk"], kernels.launches()["shear_rotate"]
    a = card.process(frames)
    torch.cuda.synchronize()
    after = kernels.launches()
    assert (after["gallery_topk"] - k1, after["shear_rotate"] - k2) == (1, 0)
    b = cpu.process(frames)
    va = a.valid.cpu()
    assert torch.equal(va, b.valid) and va.any()
    assert ((a.embeddings.cpu() * b.embeddings).sum(-1)[va] > 0.999).all()
    assert torch.equal(a.match_indices.cpu()[..., 0][va], b.match_indices[..., 0][va])


def test_packed_demo_on_the_card_matches_identify(dev, no_tf32):
    import numpy as np

    pipe = _tiny_pipeline(dev)
    frames = _demo_frames()
    ref = pipe.identify(frames)
    packed, emb = pipe.process_demo(frames)
    got = pipe.faces_from_packed(packed)
    assert emb.is_cuda and packed.shape == (2, 4, 19)
    assert [len(g) for g in got] == [len(r) for r in ref] and sum(map(len, got)) >= 2
    for g, r in ((g, r) for gf, rf in zip(got, ref) for g, r in zip(gf, rf)):
        assert g["name"] == r["name"]
        assert g["box"] == pytest.approx(r["box"], abs=1e-4)
        assert g["prob"] == pytest.approx(r["prob"], rel=1e-5)
        assert g["distance"] == pytest.approx(r["distance"], rel=1e-4)
        assert np.asarray(g["landmarks"]) == pytest.approx(np.asarray(r["landmarks"]), abs=1e-3)
    slot = got[0][0]["slot"]
    np.testing.assert_allclose(emb[0, slot].cpu().numpy(), ref[0][0]["embedding"], rtol=1e-5)
    stats = pipe.benchmark_transfer(frames, iters=2, warmup=1)
    assert stats["faces_per_sec"] > 0 and stats["host_sec_per_batch"] > 0


def test_evaluate_model_on_the_card_matches_the_cpu(dev, tmp_path, no_tf32):
    """evaluate_model and predict_image of one checkpoint, f32, on the card
    and on the CPU: the same argmax, probabilities within 1e-4."""
    import numpy as np

    from facerec_torch.config import EvalConfig
    from facerec_torch.eval.engine import evaluate_model, predict_image
    from facerec_torch.models import get_model
    from facerec_torch.models.arcface import init_like_flax
    from facerec_torch.train.checkpoints import save_checkpoint

    root = write_synthetic_imagefolder(tmp_path / "ds", num_classes=4, per_class=14, size=32,
                                       seed=4)
    for model_type in ("baseline", "arcface"):
        net = get_model(model_type, num_classes=4)
        init_like_flax(net, torch.Generator().manual_seed(2))
        save_checkpoint(tmp_path / "ck" / model_type, "best", net.state_dict())
        cfg = EvalConfig(model_type=model_type, batch_size=8, image_size=32,
                         compute_dtype="float32")
        out = [evaluate_model(cfg, root, checkpoints_root=tmp_path / "ck",
                              outputs_root=tmp_path / d.type, return_predictions=True, device=d)
               for d in (dev, torch.device("cpu"))]
        card, cpu = (o["_predictions"] for o in out)
        np.testing.assert_array_equal(card["yhat"], cpu["yhat"])
        np.testing.assert_allclose(card["probs"], cpu["probs"], atol=1e-4)
        assert out[0]["avg_inference_time_ms"] > 0
        img = sorted((root / "test").glob("*/*.jpg"))[0]
        names = [f"person_{i:03d}" for i in range(4)]
        p = [predict_image(img, cfg, names, checkpoints_root=tmp_path / "ck", device=d)
             for d in (dev, torch.device("cpu"))]
        assert p[0]["predicted_class"] == p[1]["predicted_class"] == names[card["yhat"][0]]


def test_augment_on_the_card_matches_the_cpu(dev):
    """``apply_augment`` on the card from CPU draws: the CPU's images
    within 1e-5 (f32 in [0, 1])."""
    from facerec_torch.ops.augment import AugmentParams, apply_augment, draw_augment

    x = torch.rand(8, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    for p in (AugmentParams(), AugmentParams(horizontal_flip=False, p_geometry=1.0)):
        d = draw_augment(torch.Generator().manual_seed(1), 8, p)
        got = apply_augment(x.to(dev), d, p).cpu()
        assert (got - apply_augment(x, d, p)).abs().max().item() <= 1e-5


def test_detector_training_on_the_card_matches_the_cpu(dev, no_tf32):
    """3 f32 ``train_net`` steps per net on the card against the CPU, from
    the same seeded weights, samples and indices (chip_smoke's bars)."""
    from chip_smoke import DET_RTOL, _net_agrees
    from facerec_torch.detect.mtcnn import ONet, PNet, RNet

    for cls, size, seed, lm in ((PNet, 12, 0, False), (RNet, 24, 1, False), (ONet, 48, 2, True)):
        res = _net_agrees(dev, cls, size, seed, lm)
        assert res["loss_max_rel"] <= DET_RTOL and res["param_rel"] <= DET_RTOL, res


def test_preprocessing_on_the_card_matches_the_cpu(dev, no_tf32):
    """``process_batch`` on the card against the CPU on 4 photos at the
    512 px work size: the same faces, within 1% of their side, and equal
    crops (within 1 level) from the same detections."""
    import numpy as np

    from chip_smoke import PREP_DET_SHARE, prep_agrees
    from facerec_torch.config import PreprocessingConfig
    from facerec_torch.data.preprocess import WORK_SIZE, BatchPreprocessor
    from facerec_torch.data.synthetic import face_frames
    from facerec_torch.detect.weights import load_default_detector

    cfg = PreprocessingConfig()
    pre = BatchPreprocessor(cfg, load_default_detector((WORK_SIZE, WORK_SIZE), device=dev),
                            device=dev)
    photos = list(face_frames(4, (480, 640), 1, np.random.default_rng(0)).astype(np.uint8))
    res = prep_agrees(pre, photos)
    assert res["detections_valid_equal"], res
    assert res["box_landmark_max_share_of_side"] <= PREP_DET_SHARE, res
    assert res["same_detections_levels"]["max"] <= 1, res


def test_facenet_step_on_the_card_matches_the_cpu(dev, no_tf32):
    """chip_smoke's small-input check with a full-width InceptionResnetV1
    embedder: the serve step on the card (K1 and K2 launched once a step)
    against the CPU step, the same valid slots, cosine > 0.999, the same
    top-1. Two replays of one captured step, after its warm-up runs."""
    from chip_smoke import small_input_agrees

    k1, k2 = kernels.launches()["gallery_topk"], kernels.launches()["shear_rotate"]
    small_input_agrees(dev, "facenet")
    steps = 2 + WARMUP_RUNS
    after = kernels.launches()
    assert (after["gallery_topk"] - k1, after["shear_rotate"] - k2) == (steps, steps)


@pytest.mark.parametrize("embedder", ["arcface", "facenet"])
def test_fold_on_the_card_matches_unfolded(dev, no_tf32, embedder):
    """``fold_batchnorm`` of a bf16 embedder on the card, its BatchNorm
    statistics randomised: cosine against unfolded > 1 - FOLD_COS."""
    from chip_smoke import FOLD_COS, randomize_batchnorm
    from facerec_torch.models.facenet import build_facenet_embedder
    from facerec_torch.models.fold import fold_batchnorm

    if embedder == "arcface":
        net = build_embedder(dtype=torch.bfloat16, device=dev)
    else:
        net = build_facenet_embedder(repeats=(1, 1, 1), dtype=torch.bfloat16, device=dev)
    randomize_batchnorm(net, 3)
    folded = fold_batchnorm(net)
    x = torch.rand(8, 160, 160, 3, generator=torch.Generator().manual_seed(0)).to(dev) * 255
    with torch.no_grad():
        cos = (net.embed(x) * folded.embed(x)).sum(-1)
    assert cos.min().item() > 1 - FOLD_COS


def _nms_inputs(m, n, gen, dev, ties: bool = True, side=(2.0, 30.0), span=64.0):
    """Random NMS rows: boxes with f32 corners (non-integer, so that the
    overlaps round), sides in ``side`` inside a ``span`` square (dense
    overlaps and chains), scores on a coarse grid (many ties) or continuous,
    10% invalid; s0 is the scores masked to -inf as ``nms`` masks them."""
    xy = torch.rand(m, n, 2, generator=gen, device=dev) * span
    wh = side[0] + torch.rand(m, n, 2, generator=gen, device=dev) * (side[1] - side[0])
    boxes = torch.cat([xy, xy + wh], -1)
    scores = torch.rand(m, n, generator=gen, device=dev)
    if ties:
        scores = torch.floor(scores * 8) / 8
    valid = torch.rand(m, n, generator=gen, device=dev) > 0.1
    return boxes, torch.where(valid, scores, float("-inf")), valid


def _assert_suppression_agrees(boxes, s0, valid, threshold=0.5, mode="union"):
    """The fused kernel against its plain version, keep and rounds equal,
    one launch."""
    before = kernels.launches()["nms_suppress"]
    keep, rounds = nms_suppress(boxes, s0, valid, threshold, mode)
    ref_keep, ref_rounds = nms_suppress_plain(boxes, s0, valid, threshold, mode)
    torch.cuda.synchronize()
    assert kernels.launches()["nms_suppress"] == before + 1
    assert torch.equal(keep, ref_keep) and torch.equal(rounds, ref_rounds), (mode, threshold)
    return keep, rounds


@pytest.mark.parametrize("n", [1, 20, 36, 37, 64, 192, 512, MAX_N])
@pytest.mark.parametrize("density", [0.02, 0.3])
def test_nms_kernel_matches_plain(dev, n, density):
    """Random rows at the serve step's widths (20, 32 + 4, 64, 192), at 1,
    37, 512 and the kernel's limit, with sparse (``density`` 0.02: small
    boxes) and dense overlaps, tied and continuous scores, in each mode:
    keep and rounds equal to the plain version's."""
    gen = torch.Generator(device=dev).manual_seed(n)
    m = 7 if n > 64 else 130
    span = 64.0 if density > 0.1 else 64.0 * math.sqrt(n)
    for mode in MODES:
        for ties in (True, False):
            _assert_suppression_agrees(*_nms_inputs(m, n, gen, dev, ties, span=span), 0.5, mode)


@pytest.mark.parametrize("n", [20, 64, 512, MAX_N])
def test_nms_kernel_ladders(dev, n):
    """A ladder of boxes, each 3 px right of the one before (IoU 7/13,
    min-overlap 0.7 with its neighbours, below the threshold two apart) and
    scores descending along it: a chain N - 1 deep, which takes all N
    rounds; beside it the ladder broken half-way by an invalid rung, and a
    row of boxes apart. Greedy keeps every other box."""
    k = torch.arange(n, device=dev, dtype=torch.float32)
    rung = torch.stack([3 * k, 0 * k, 3 * k + 10, 0 * k + 10], -1)
    apart = torch.stack([20 * k, 0 * k, 20 * k + 10, 0 * k + 10], -1)
    boxes = torch.stack([rung, rung, apart])
    s0 = (1.0 - k / n).expand(3, n).contiguous()
    valid = torch.ones(3, n, dtype=torch.bool, device=dev)
    valid[1, n // 2] = False
    s0 = torch.where(valid, s0, float("-inf"))
    for mode in MODES:
        keep, rounds = _assert_suppression_agrees(boxes, s0, valid, 0.5, mode)
        assert rounds.tolist() == [n, max(n // 2, n - n // 2 - 1), 1]
        assert torch.equal(keep[0], k.long() % 2 == 0)


def test_nms_kernel_misaligned_rows(dev):
    """Rows that start off a 16-byte boundary: a slice of a larger batch
    (contiguous) and a column slice (copied by the wrapper)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    boxes, s0, valid = _nms_inputs(9, 38, gen, dev)
    _assert_suppression_agrees(boxes[1:], s0[1:], valid[1:])
    _assert_suppression_agrees(boxes[:, 1:], s0[:, 1:], valid[:, 1:], 0.7, "dupmin")


def test_nms_kernel_refuses_wide_rows(dev):
    n = MAX_N + 1
    with pytest.raises(ValueError, match="at most"):
        nms_suppress(torch.zeros(1, n, 4, device=dev), torch.zeros(1, n, device=dev),
                     torch.ones(1, n, dtype=torch.bool, device=dev), 0.5)
    with pytest.raises(TypeError, match="f32"):
        nms_suppress(torch.zeros(1, 4, 4, device=dev, dtype=torch.bfloat16),
                     torch.zeros(1, 4, device=dev), torch.ones(1, 4, dtype=torch.bool,
                                                            device=dev), 0.5)


@pytest.mark.parametrize("mode", MODES)
def test_nms_kernel_threshold_ulps(dev, mode):
    """Thresholds set to the exact overlap of pairs of random f32 boxes and
    one ulp either side of it: a single rounding apart from the plain
    version's order of f32 operations flips a bit here."""
    gen = torch.Generator(device=dev).manual_seed(11)
    boxes, s0, valid = _nms_inputs(16, 64, gen, dev, side=(8.0, 40.0), span=48.0)
    ov = overlap_matrix(boxes, mode)
    picks = ov[(ov > 0.05) & (ov < 0.95)]
    assert picks.numel() > 100
    for t in picks[torch.randperm(picks.numel(), generator=gen, device=dev)[:12]].tolist():
        t32 = torch.tensor(t, dtype=torch.float32)
        for u in (torch.nextafter(t32, torch.tensor(0.0)), t32,
                  torch.nextafter(t32, torch.tensor(1.0))):
            _assert_suppression_agrees(boxes, s0, valid, float(u), mode)


@pytest.mark.parametrize("mode", MODES)
def test_nms_kernel_adversarial_rows(dev, mode):
    """Ties, zero-area boxes, exact-threshold pairs and an all-invalid row
    (``chip_smoke.nms_adversarial_rows``, which ``tests/test_torch_nms.py``
    holds against JAX's ``nms`` on the CPU), boxes with NaN and infinite corners, and one box a row."""
    boxes, scores, valid = (torch.from_numpy(a).to(dev) for a in nms_adversarial_rows())
    s0 = torch.where(valid, scores, float("-inf"))
    _assert_suppression_agrees(boxes, s0, valid, 0.5, mode)
    odd = boxes.clone()
    odd[1, 8] = torch.tensor([float("nan"), 0.0, 10.0, 10.0])
    odd[1, 9] = torch.tensor([0.0, 0.0, float("inf"), 10.0])
    odd[1, 10] = torch.tensor([float("-inf"), float("-inf"), float("inf"), float("inf")])
    odd[1, 11] = torch.tensor([0.0, 0.0, float("inf"), 0.0])
    _assert_suppression_agrees(odd, s0, valid, 0.5, mode)
    _assert_suppression_agrees(boxes[:, :1].contiguous(), s0[:, :1].contiguous(),
                               valid[:, :1].contiguous(), 0.5, mode)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(256, 64, 40, 40), (64, 512, 5, 5), (256, 512)])
def test_global_batch_norm_native_matches_plain(dev, shape, dtype):
    """The native global BatchNorm (``nn.SyncBatchNorm``'s fused kernels) on
    a one-rank data axis against its plain version on the same inputs,
    ``chip_smoke.batchnorm_case``'s bars: output, input gradient, weight and
    bias gradients, and the running statistics after one step."""
    from chip_smoke import batchnorm_case

    out = batchnorm_case(dev, shape, dtype, seed=3)
    assert out["ok"], out


def _results_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("precise", [False, True])
def test_captured_step_matches_eager(dev, no_tf32, precise):
    """The replayed graph against the eager ``step`` on the same frames,
    every field equal, on the fast and the precise path; the second replay
    reuses the graph, and each call returns buffers of its own."""
    pipe = _tiny_pipeline(dev, precise)
    x = pipe.upload(_demo_frames())
    eager = pipe.step(x)
    first = pipe.run_step(x)
    second = pipe.run_step(x)
    torch.cuda.synchronize()
    assert len(pipe._graphs) == 1
    assert _results_equal(first, eager) and _results_equal(second, eager)
    statics = {t.data_ptr() for cap in pipe._graphs.values() for t in cap.outputs}
    assert not statics & {t.data_ptr() for t in (*first, *second)}


def test_launches_per_replay(dev, no_tf32):
    """One replay adds what its capture recorded: K1 1, K2 1 (0 on the
    precise path), the NMS kernel 5, the crop kernel 3 (R-Net, O-Net and
    align; 2 on the precise path, whose align gathers) and no epilogue
    pass."""
    for precise, k2, crops in ((False, 1, 3), (True, 0, 2)):
        pipe = _tiny_pipeline(dev, precise)
        x = pipe.upload(_demo_frames())
        pipe.run_step(x)
        before = kernels.launches()
        pipe.run_step(x)
        after = kernels.launches()
        assert {k: n - before[k] for k, n in after.items()} == {
            "gallery_topk": 1, "shear_rotate": k2, "nms_suppress": 5, "crop_resize": crops,
            "iresnet_epilogue": 0}


def test_two_dispatches_in_flight(dev, no_tf32):
    """Two frames dispatched before either is read back: each equals its
    own serial result, and neither aliases the graph's static buffers."""
    pipe = _tiny_pipeline(dev)
    frames = _demo_frames()
    serial = [pipe.process_demo(frames[i:i + 1]) for i in (0, 1)]
    first = pipe.dispatch_demo(frames[0:1])
    second = pipe.dispatch_demo(frames[1:2])
    statics = {t.data_ptr() for cap in pipe._graphs.values() for t in cap.outputs}
    assert not statics & {t.data_ptr() for t in (*first, *second)}
    for (packed, emb), (ref_packed, ref_emb) in zip((first, second), serial):
        assert (packed.cpu().numpy() == ref_packed).all()
        assert torch.equal(emb, ref_emb)
    assert not (serial[0][0] == serial[1][0]).all()


def test_enrolment_between_replays(dev, no_tf32):
    """An enrolment after the capture is seen by the next replay: the
    enrolled face matches its own new row, as the eager step says."""
    pipe = _tiny_pipeline(dev)
    x = pipe.upload(_demo_frames())
    r = pipe.run_step(x)
    face = r.embeddings[r.valid][0].cpu().numpy()
    row = pipe.gallery.add("enrolled", face)
    again = pipe.run_step(x)
    torch.cuda.synchronize()
    assert len(pipe._graphs) == 1
    assert _results_equal(again, pipe.step(x))
    slot = r.valid.nonzero()[0].tolist()
    assert again.match_indices[slot[0], slot[1], 0].item() == row
    assert again.is_match[slot[0], slot[1]].item()
    pipe.gallery.remove("enrolled")
    assert _results_equal(pipe.run_step(x), pipe.step(x))


def test_demo_double_buffering_on_the_card(dev, no_tf32):
    """``FaceDemo.submit_frame`` on the card, one frame behind, reads each
    frame back on its side stream: the faces equal the serial path's."""
    from facerec_torch.serve.app import FaceDemo, synthetic_frame_source

    pipe = _tiny_pipeline(dev)
    src = synthetic_frame_source((96, 96))
    frames = [src() for _ in range(4)]
    serial = [FaceDemo(pipe, frame_source=lambda: None).process_frame(f) for f in frames]
    demo = FaceDemo(pipe, frame_source=lambda: None)
    assert demo.submit_frame(frames[0]) is None
    got = [demo.submit_frame(f)[1] for f in frames[1:]] + [demo.flush()[1]]
    for g, r in zip(got, serial):
        assert [(f["slot"], f["name"], f["box"]) for f in g] == [
            (f["slot"], f["name"], f["box"]) for f in r]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_captured_train_step_matches_eager(dev, no_tf32, compute_dtype):
    """Three replays of the captured train step against three eager steps
    from copies of one state (dropout on, deterministic cuDNN): loss_sum,
    grad_norm and every parameter and buffer bit for bit, the step count on
    the device and the host's step advanced alike; a new state captures
    anew, also while a tensor of the dropped graph's pool is still alive."""
    import copy

    from facerec_torch.models import get_model
    from facerec_torch.train.state import create_train_state
    from facerec_torch.train.steps import make_train_step

    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"image": torch.randn(8, 64, 64, 3, generator=gen, device=dev),
             "label": torch.arange(8, device=dev, dtype=torch.int32) % 4,
             "mask": torch.ones(8, device=dev)}
    base = create_train_state(get_model("arcface", num_classes=4), TrainConfig(seed=0),
                              "arcface", dev)
    base.epoch = 2.0
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        states = [copy.deepcopy(base) for _ in range(2)]
        step = make_train_step("arcface", compute_dtype)
        for _ in range(3):
            got, want = step(states[0], batch), step.eager(states[1], batch)
            assert all(torch.equal(got[k], want[k]) for k in want)
            assert all(torch.equal(a, b) for a, b in zip(states[0].model.state_dict().values(),
                                                         states[1].model.state_dict().values()))
        assert len(step._graphs) == 1
        assert states[0].step == states[1].step == 3
        assert states[0].opt_state.count == states[1].opt_state.count == 3
        held = next(iter(step._graphs.values())).metrics  # keeps the first pool in use
        other = copy.deepcopy(base)
        step(other, batch)
        assert step._graph_inputs[0] is other and other.step == 1
        assert torch.isfinite(held["loss_sum"])
    finally:
        torch.backends.cudnn.deterministic = prev


def test_bench_on_the_card(dev, no_tf32):
    """``facerec_torch.bench`` at 2 frames of 240 x 320 and a 16-row
    gallery: bench.py's keys less ``vs_baseline``, the fill, CUDA-event
    timing."""
    from facerec_torch import bench

    pipe, frames = bench.prepare(batch=2, gallery=16, frame_hw=(240, 320), device=dev)
    out, note = bench.measure(pipe, frames, iters=2)
    assert tuple(out) == ("metric", "value", "unit", "detected", "detected_expected",
                          "detected_ok", "detected_p090", "detected_p090_ok")
    assert out["detected_ok"] and out["value"] > 0 and out["detected_expected"] == 16
    assert note["timing"] == "cuda_events" and note["device_ms_per_step"] > 0
    assert note["card"].startswith("NVIDIA")


def test_serve_recaptures_while_the_old_pool_is_in_use(dev, no_tf32):
    """A new detector object captures the step anew, with the old graph's
    outputs still referenced (its memory pool not yet free)."""
    import copy

    pipe = _tiny_pipeline(dev)
    frames = _demo_frames()
    first = pipe.process(frames)
    held = next(iter(pipe._graphs.values())).outputs
    pipe.detector = copy.deepcopy(pipe.detector)
    again = pipe.process(frames)
    assert _results_equal(again, first) and len(held) == len(first)
