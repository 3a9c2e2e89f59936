"""A serve run on the CPU at a small size, driven as on the card but for
the look for a card, with the timed path broken underneath: each fault
that a serve cell can have makes ``correct`` false."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import harness
from perfbench.drivers import serve
from perfbench.tests.small import small

CELLS = [w["name"] for w in harness.load_spec()["workloads"]
         if harness.cell(w["name"])["traffic"]["driver"] == "serve"]
SEED = 2 ** 31 + 77


def correct_after_run(c: dict) -> tuple[bool, dict]:
    torch.manual_seed(0)
    out = serve.run(c, SEED, 0.5, False, time.perf_counter(), "cpu")
    return harness.decide(c["limits"], out["numbers"], out["failed"])[0], out["numbers"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    ok, numbers = correct_after_run(small(name))
    assert ok, numbers


def _wrap(monkeypatch, owner, attr, make):
    orig = getattr(owner, attr)
    monkeypatch.setattr(owner, attr, make(orig))


@pytest.mark.parametrize("name", CELLS)
def test_an_embedding_altered_where_produced_is_caught(monkeypatch, name):
    from facerec_torch.serve import pipeline

    def make(orig):
        def step(self, frames):
            r = orig(self, frames)
            emb = r.embeddings.clone()
            emb[0, 0] = -emb[0, 0]
            return r._replace(embeddings=emb)
        return step
    _wrap(monkeypatch, pipeline.FacePipeline, "step", make)
    assert not correct_after_run(small(name))[0]


@pytest.mark.parametrize("name", CELLS)
def test_a_match_altered_where_produced_is_caught(monkeypatch, name):
    from facerec_torch.serve import pipeline

    def make(orig):
        def topk(q, g, count, k=5):
            v, i = orig(q, g, count, k)
            return v, (i + 1) % int(count)
        return topk
    _wrap(monkeypatch, pipeline, "gallery_topk", make)
    assert not correct_after_run(small(name))[0]


@pytest.mark.parametrize("name", CELLS)
def test_a_box_altered_where_produced_is_caught(monkeypatch, name):
    from facerec_torch.detect import mtcnn

    def make(orig):
        def detect(self, images):
            d = orig(self, images)
            w = d.boxes[..., 2] - d.boxes[..., 0]
            shift = torch.stack([w, torch.zeros_like(w), w, torch.zeros_like(w)], -1) * 0.4
            return d._replace(boxes=d.boxes + shift)
        return detect
    _wrap(monkeypatch, mtcnn.MTCNN, "detect", make)
    assert not correct_after_run(small(name))[0]


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out_is_caught(monkeypatch, name):
    from facerec_torch.serve import pipeline

    def make(orig):
        def step(self, frames):
            r = orig(self, frames)
            valid = r.valid.clone()
            valid[valid.shape[0] // 2:] = False
            return r._replace(valid=valid)
        return step
    _wrap(monkeypatch, pipeline.FacePipeline, "step", make)
    assert not correct_after_run(small(name))[0]

