"""Parity of the port's detect stage with the JAX package on the CPU: NMS in
its three overlap modes, the cascade's pieces, and the whole MTCNN with the
committed ``outputs/detector`` weights, in f32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_torch.data.synthetic import face_frames
from facerec_torch.detect import mtcnn as tm
from facerec_torch.detect.weights import load_detector_params
from facerec_torch.ops.image import bbox_with_margin, resize_bilinear
from facerec_torch.ops.nms import nms, overlap_matrix
from facerec_tpu.detect import mtcnn as jm
from facerec_tpu.detect.weights import load_detector_params as jax_load
from facerec_tpu.ops.image import bbox_with_margin as jax_margin
from facerec_tpu.ops.image import resize_bilinear as jax_resize
from facerec_tpu.ops.nms import nms as jax_nms
from facerec_tpu.ops.nms import overlap_matrix as jax_overlap

HW = (120, 160)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _boxes(seed=3, n=40, lo=5, hi=25):
    """The inputs of tests/test_ops.py::test_nms_vs_oracle."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(10, 90, (n, 2))
    sizes = rng.uniform(lo, hi, (n, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], 1).astype(np.float32)
    return boxes, rng.uniform(size=n).astype(np.float32), rng


@pytest.mark.parametrize("mode", ["union", "min", "dupmin"])
@pytest.mark.parametrize("case", ["oracle", "masked", "tied"])
def test_nms_matches_jax(mode, case):
    boxes, scores, rng = _boxes()
    valid = np.ones(len(boxes), bool)
    max_out = None
    if case == "masked":  # tests/test_ops.py::test_nms_unroll_invariant's shape
        boxes, scores, rng = _boxes(11, 64, 5, 40)
        valid = rng.uniform(size=64) > 0.2
        max_out = 16
    elif case == "tied":  # bf16-like quantised scores: many exact ties
        scores = np.round(scores * 4) / 4
    ref = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.4, mode, max_out)
    got = nms(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid),
              0.4, mode, max_out)
    rb, rs, rk, ri = (np.asarray(a) for a in ref)
    gb, gs, gk, gi = (a.numpy() for a in got)
    np.testing.assert_array_equal(gk, rk)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gb, rb)
    np.testing.assert_array_equal(gs, rs)
    np.testing.assert_allclose(overlap_matrix(torch.from_numpy(boxes), mode).numpy(),
                               np.asarray(jax_overlap(jnp.asarray(boxes), mode)), atol=1e-6)


def test_nms_unroll_invariant_and_batched():
    boxes, scores, rng = _boxes(11, 64, 5, 40)
    valid = torch.from_numpy(rng.uniform(size=64) > 0.2)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    ref = nms(b, s, valid, 0.4, "union", 16, unroll=1)
    for u in (2, 4, 7):
        for x, y in zip(ref, nms(b, s, valid, 0.4, "union", 16, unroll=u)):
            assert torch.equal(x, y)
    stacked = nms(torch.stack([b, b.flip(0)]), torch.stack([s, s.flip(0)]),
                  torch.stack([valid, valid.flip(0)]), 0.4, "union", 16)
    for x, y in zip(ref, stacked):
        assert torch.equal(x, y[0])


def test_pyramid_resize_and_margin_match_jax():
    assert tm.pyramid_scales(480, 640, 40) == jm.pyramid_scales(480, 640, 40)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 120, 160, 3)).astype(np.float32)
    for hw in [(30, 40), (51, 68), (12, 16)]:
        np.testing.assert_allclose(resize_bilinear(torch.from_numpy(x), hw).numpy(),
                                   np.asarray(jax_resize(jnp.asarray(x), hw)), atol=1e-5)
    boxes, _, _ = _boxes()
    np.testing.assert_allclose(bbox_with_margin(torch.from_numpy(boxes), 0.4, (60, 80)).numpy(),
                               np.asarray(jax_margin(jnp.asarray(boxes), 0.4, (60, 80))), atol=1e-5)


def test_demote_nested_matches_jax():
    rng = np.random.default_rng(5)
    boxes = np.concatenate([_boxes(7, 20, 5, 60)[0][None], _boxes(8, 20, 2, 80)[0][None]])
    scores = rng.uniform(size=(2, 20)).astype(np.float32)
    valid = rng.uniform(size=(2, 20)) > 0.3
    ref = np.asarray(jm.demote_nested(jnp.asarray(boxes), jnp.asarray(scores),
                                      jnp.asarray(valid), 2.5))
    got = tm.demote_nested(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(valid), 2.5).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got < scores).any()


def test_normalize_matches_jax_including_dark_frames():
    frames = np.random.default_rng(1).uniform(0, 255, (2, *HW, 3)).astype(np.float32)
    frames[1] = frames[1] * 0.1 + 20  # underexposed: std < 24
    det_j = jm.MTCNN(HW, min_face_size=40, input_range="255")
    det_t = tm.MTCNN(HW, min_face_size=40, input_range="255", device="cpu")
    np.testing.assert_allclose(det_t.normalize(torch.from_numpy(frames)).numpy(),
                               np.asarray(det_j.normalize(jnp.asarray(frames))), atol=1e-5)


@pytest.fixture(scope="module")
def frames():
    return face_frames(2, HW, 1, np.random.default_rng(0))


KW = dict(min_face_size=40, max_faces=2, k_pnet=16, k_rnet=8, input_range="255")


@pytest.fixture(scope="module")
def detectors():
    det_t = tm.MTCNN(HW, **KW, device="cpu").load_jax_params(load_detector_params())
    return jm.MTCNN(HW, **KW), jax_load(), det_t


def test_mtcnn_stage1_matches_jax(frames, detectors):
    det_j, params, det_t = detectors
    xj = det_j.normalize(jnp.asarray(frames))
    bj, sj, vj = jax.jit(det_j.stage1)(params, xj)
    with torch.no_grad():
        bt, st, vt = det_t.stage1(det_t.normalize(torch.from_numpy(frames)))
    valid = np.asarray(vj)
    assert valid.any()
    np.testing.assert_array_equal(vt.numpy(), valid)
    np.testing.assert_allclose(bt.numpy()[valid], np.asarray(bj)[valid], atol=1e-2)
    np.testing.assert_allclose(st.numpy()[valid], np.asarray(sj)[valid], atol=1e-4)


def test_mtcnn_stages23_match_jax(frames, detectors):
    """R-Net and O-Net fed the same stage-1 candidates on both sides, held
    against the JAX stages run op by op (``disable_jit``): XLA's fusion under
    ``jit`` moves last f32 bits, which the bf16 crop rounding then amplifies
    (see test_mtcnn_matches_jax)."""
    det_j, params, det_t = detectors
    xj = det_j.normalize(jnp.asarray(frames))
    bj, _, vj = jax.jit(det_j.stage1)(params, xj)
    with jax.disable_jit():
        ref = det_j._stages23(params, xj, bj, vj)
    with torch.no_grad():
        got = det_t._stages23(*(torch.from_numpy(np.array(a)) for a in (xj, bj, vj)))
    valid = np.asarray(ref.valid)
    assert valid.sum(axis=1).min() >= 1
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.boxes.numpy()[valid], np.asarray(ref.boxes)[valid], atol=1e-2)
    np.testing.assert_allclose(got.landmarks.numpy()[valid], np.asarray(ref.landmarks)[valid],
                               atol=1e-2)
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(ref.probs), atol=1e-4)


def test_mtcnn_matches_jax(frames, detectors):
    """The whole cascade against the jitted JAX cascade. Past stage 1 the
    bf16 rounding of crop weights and pixels amplifies the last-bit f32
    differences that XLA's fusion makes under ``jit``, so the bounds here are
    0.25 px and 1e-3; test_mtcnn_stages23_match_jax holds stages 2 and 3 to
    1e-2 px and 1e-4 against the JAX stages run op by op."""
    det_j, params, det_t = detectors
    ref = det_j.detect(params, jnp.asarray(frames))
    got = det_t.detect(torch.from_numpy(frames))
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum(axis=1).min() >= 1  # at least one face found in every frame
    np.testing.assert_allclose(got.boxes.numpy()[valid], np.asarray(ref.boxes)[valid], atol=0.25)
    np.testing.assert_allclose(got.landmarks.numpy()[valid], np.asarray(ref.landmarks)[valid],
                               atol=0.25)
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(ref.probs), atol=1e-3)


def test_face_frames_do_not_depend_on_hash_seed():
    """The port's renderer draws the hair style with crc32, so one seed gives
    the same frames in every process (the JAX renderer's ``hash()`` draw
    changes with PYTHONHASHSEED)."""
    import os
    import subprocess
    import sys

    code = ("import numpy as np\n"
            "from facerec_torch.data.synthetic import face_frames\n"
            "print(repr(float(face_frames(1, (160, 160), 4, np.random.default_rng(0)).sum())))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sums = set()
    for seed in ("1", "2", "3"):
        out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                             text=True, timeout=120, env={**os.environ, "PYTHONHASHSEED": seed})
        assert out.returncode == 0, out.stderr
        sums.add(out.stdout.strip())
    assert len(sums) == 1, sums
