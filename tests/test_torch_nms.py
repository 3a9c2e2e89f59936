"""The port's NMS against the JAX package's ``nms`` on the CPU, where the
port takes the plain version of its kernel (``nms_suppress_plain``: the
overlap matrix, the score order and ``nms_fixed_point_plain``): rows of
adversarial pairs (tied scores, overlaps exactly at the threshold,
zero-area boxes, an all-invalid row); ladders of boxes, each
overlapping the next, whose suppression chains run up to N deep (far past
the 4-round unroll), with scores that descend along the ladder or are all
equal (ties to the lower index), in all three overlap modes; and random
boxes drawn by hypothesis. Batches go through ``jax.vmap`` on the JAX side.
Outputs are compared exactly: integer-valued boxes keep every overlap exact
in f32 on both sides."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chip_smoke import nms_adversarial_rows
from facerec_torch.ops.nms import (nms, nms_fixed_point_plain, nms_suppress, nms_suppress_plain,
                                   overlap_matrix)
from facerec_tpu.ops.nms import nms as jax_nms

MODES = ("union", "min", "dupmin")
THRESHOLD = 0.5
SIDE, SHIFT = 10.0, 3.0  # neighbours: IoU 7/13, min-overlap 0.7; two apart: 0.25, 0.4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def ladder(n: int, length: int, tied: bool, rng) -> tuple[np.ndarray, np.ndarray]:
    """[n, 4] boxes and [n] scores: boxes 0..length-1 a ladder, each SHIFT px
    right of the one before, so that each overlaps its neighbours past
    THRESHOLD in every mode and the boxes two apart below it; scores
    descending along the ladder (or all equal, the ladder then ordered by
    index). The other boxes sit apart in a row below, never overlapping."""
    boxes = np.zeros((n, 4), np.float32)
    k = np.arange(length, dtype=np.float32)
    boxes[:length] = np.stack([k * SHIFT, 0 * k, k * SHIFT + SIDE, 0 * k + SIDE], 1)
    r = np.arange(n - length, dtype=np.float32)
    boxes[length:] = np.stack([2 * SIDE * r, 0 * r + 100, 2 * SIDE * r + SIDE, 0 * r + 110], 1)
    if tied:
        scores = np.full(n, 0.5, np.float32)
    else:
        scores = rng.permutation(n).astype(np.float32) / n
        scores[:length] = np.sort(rng.uniform(1.0, 2.0, length).astype(np.float32))[::-1]
    return boxes, scores


def _jax_batched(boxes, scores, valid, mode, max_out):
    fn = jax.vmap(functools.partial(jax_nms, threshold=THRESHOLD, mode=mode, max_out=max_out))
    return [np.asarray(a) for a in fn(jnp.asarray(boxes), jnp.asarray(scores),
                                      jnp.asarray(valid))]


def _assert_nms_equal(boxes, scores, valid, mode, max_out):
    ref = _jax_batched(boxes, scores, valid, mode, max_out)
    got = nms(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid),
              THRESHOLD, mode, max_out)
    for name, g, r in zip(("boxes", "scores", "keep", "index"), got, ref):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    return got


def _sup_keep0(boxes, scores, valid, mode):
    """The suppression matrix and candidates ``nms`` hands the fixed point."""
    b, s, v = (torch.from_numpy(a) for a in (boxes, scores, valid))
    n = b.shape[-2]
    s0 = torch.where(v, s, float("-inf"))
    idx = torch.arange(n)
    sj, si = s0[..., None, :], s0[..., :, None]
    dominates = (sj > si) | ((sj == si) & (idx[None, :] < idx[:, None]))
    sup = (overlap_matrix(b, mode) > THRESHOLD) & dominates & v[..., None, :]
    return sup, v & (s0 > float("-inf"))


@pytest.mark.parametrize("mode", MODES)
def test_suppression_plain_matches_jax_on_adversarial_rows(mode):
    """``nms_suppress_plain`` (through ``nms`` on the CPU) against JAX's
    ``nms`` on ``chip_smoke.nms_adversarial_rows``: the kept set and every output equal;
    an overlap equal to the threshold does not suppress."""
    boxes, scores, valid = nms_adversarial_rows()
    got = _assert_nms_equal(boxes, scores, valid, mode, None)
    s0 = torch.where(torch.from_numpy(valid), torch.from_numpy(scores), float("-inf"))
    keep, _ = nms_suppress_plain(torch.from_numpy(boxes), s0, torch.from_numpy(valid),
                                 THRESHOLD, mode)
    kept = got[2].numpy()
    for row in range(len(boxes)):
        assert set(got[3][row].numpy()[kept[row]]) == set(np.flatnonzero(keep[row].numpy()))
    assert not keep[2].any()
    assert keep[3].tolist()[:4] == [False, True, False, False]
    at_threshold = 1 if mode == "union" else 3  # its partner scores the same, lower index
    assert keep[0, at_threshold]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [20, 36, 64, 512])
@pytest.mark.parametrize("tied", [False, True])
def test_ladders_match_jax(mode, n, tied):
    """A batch of ladders: the whole row (chain depth N - 1), a 5-rung one,
    one broken by an invalid rung, and no ladder; greedy keeps every other
    rung. The plain fixed point takes depth + 1 rounds."""
    rng = np.random.default_rng(n)
    lengths = [n, 5, n, 0]
    rows = [ladder(n, length, tied, rng) for length in lengths]
    boxes = np.stack([r[0] for r in rows])
    scores = np.stack([r[1] for r in rows])
    valid = np.ones((len(rows), n), bool)
    valid[2, n // 2] = False  # two ladders, each from its own top
    got = _assert_nms_equal(boxes, scores, valid, mode, None)
    kept = got[2].numpy()
    np.testing.assert_array_equal(kept[0].sum(), (n + 1) // 2)
    _, rounds = nms_fixed_point_plain(*_sup_keep0(boxes, scores, valid, mode))
    assert rounds.tolist() == [n, 5, max(n // 2, n - n // 2 - 1), 1]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("max_out", [8, 16])
def test_truncated_ladders_match_jax(mode, max_out):
    """The serve step's final call: 20 and 36 slots cut to ``max_faces``."""
    rng = np.random.default_rng(max_out)
    for n in (20, 36):
        rows = [ladder(n, length, tied, rng) for length, tied in ((n, False), (n, True),
                                                                  (7, False), (3, True))]
        boxes = np.stack([r[0] for r in rows])
        scores = np.stack([r[1] for r in rows])
        valid = rng.uniform(size=(len(rows), n)) > 0.1
        _assert_nms_equal(boxes, scores, valid, mode, max_out)


@pytest.mark.parametrize("unroll", [1, 2, 4, 7])
def test_plain_fixed_point_does_not_depend_on_unroll(unroll):
    rng = np.random.default_rng(1)
    rows = [ladder(64, length, False, rng) for length in (64, 9, 1)]
    boxes = np.stack([r[0] for r in rows])
    scores = np.stack([r[1] for r in rows])
    sup, keep0 = _sup_keep0(boxes, scores, np.ones((3, 64), bool), "union")
    ref_keep, ref_rounds = nms_fixed_point_plain(sup, keep0, 1)
    keep, rounds = nms_fixed_point_plain(sup, keep0, unroll)
    assert torch.equal(keep, ref_keep) and torch.equal(rounds, ref_rounds)
    assert ref_rounds.tolist() == [64, 9, 1]


def test_fixed_point_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the NMS wrapper is the plain version and counts no
    launch: the fixed point of the suppression matrix that ``nms`` builds;
    empty batches and rows pass through."""
    rng = np.random.default_rng(2)
    boxes, scores = ladder(36, 36, False, rng)
    valid = np.ones((1, 36), bool)
    sup, keep0 = _sup_keep0(boxes[None], scores[None], valid, "min")
    args = (torch.from_numpy(boxes[None]), torch.from_numpy(scores[None]),
            torch.from_numpy(valid), THRESHOLD, "min")
    before = nms_suppress.launches
    keep, rounds = nms_suppress(*args)
    assert nms_suppress.launches == before
    ref = nms_fixed_point_plain(sup, keep0)
    assert torch.equal(keep, ref[0]) and torch.equal(rounds, ref[1])
    empty = nms_suppress(torch.zeros(0, 5, 4), torch.zeros(0, 5),
                         torch.zeros(0, 5, dtype=torch.bool), THRESHOLD)
    assert empty[0].shape == (0, 5) and empty[1].shape == (0,)
    out = nms(torch.zeros(2, 0, 4), torch.zeros(2, 0), torch.zeros(2, 0, dtype=torch.bool))
    assert out[0].shape == (2, 0, 4)


@settings(max_examples=40, deadline=None)
@given(data=st.data(), n=st.sampled_from([20, 36]), mode=st.sampled_from(MODES),
       max_out=st.sampled_from([None, 8]), batch=st.integers(1, 3))
def test_random_boxes_match_jax(data, n, mode, max_out, batch):
    """Integer boxes 2-30 px wide in a 64 px square (dense overlaps and
    chains), scores on a coarse grid (many exact ties), random validity."""
    seed = data.draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 64, (batch, n, 2))
    wh = rng.integers(2, 31, (batch, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = (rng.integers(0, 8, (batch, n)) / 8).astype(np.float32)
    valid = rng.uniform(size=(batch, n)) > data.draw(st.sampled_from([0.0, 0.3]))
    _assert_nms_equal(boxes, scores, valid, mode, max_out)
