"""``tools/export_embedder.py``: the committed orbax ``arcface_synth``
checkpoint as a checkpoint of the port, which ``build_embedder`` and
``build_default_pipeline`` load and which embeds as the JAX package's
``ArcFaceNet.embed`` does on the orbax weights."""

import logging
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import facerec_torch.serve.app as app
from facerec_torch.config import ServeConfig
from facerec_torch.models.arcface import build_embedder
from facerec_tpu.models import get_model
from facerec_tpu.train.checkpoints import load_checkpoint as jax_load_checkpoint

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
from export_embedder import DEFAULT_SRC, OUT_NAME, export_embedder  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    out = tmp_path_factory.mktemp("ck") / "arcface_synth"
    return export_embedder(DEFAULT_SRC, out)


def test_exported_embedder_matches_jax(exported):
    tree = jax_load_checkpoint(DEFAULT_SRC.parent, DEFAULT_SRC.name)
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    n_cls = int(tree["params"]["arc_weight"].shape[0])
    crops = np.random.default_rng(0).uniform(0, 255, (4, 96, 96, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: get_model("arcface", num_classes=n_cls).apply(
        v, x, method="embed"))(variables, crops))
    net = build_embedder(checkpoint=exported, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got = net.embed(torch.from_numpy(crops)).numpy()
    assert exported.name == OUT_NAME and net.arc_weight.shape == (n_cls, 512)
    cos = np.sum(got * ref, axis=1) / np.linalg.norm(ref, axis=1)
    assert np.all(1.0 - cos < 1e-4), 1.0 - cos


def test_default_pipeline_serves_the_export(exported, tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(app, "CHECKPOINTS_DIR", exported.parent.parent)
    monkeypatch.setattr(app, "FACE_REFERENCES_DIR", tmp_path / "refs")
    monkeypatch.delenv("FACEREC_FACENET_WEIGHTS", raising=False)
    with caplog.at_level(logging.WARNING, logger="facerec_torch"):
        pipe = app.build_default_pipeline((96, 96), ServeConfig(max_faces=2), device="cpu")
    assert not any("random-init" in r.getMessage() for r in caplog.records)
    state = torch.load(exported / "state.pt", weights_only=True)["model"]
    torch.testing.assert_close(pipe.embedder.arc_weight.float(),
                               state["arc_weight"].to(torch.bfloat16).float())


def test_default_output_is_ignored_by_git():
    """The tool's default output, ``outputs/checkpoints/arcface_synth/
    final``, has its own line in ``.gitignore``: a run commits no weights."""
    assert DEFAULT_SRC.parent / OUT_NAME == REPO / "outputs/checkpoints/arcface_synth/final"
    lines = (REPO / ".gitignore").read_text().splitlines()
    assert f"outputs/checkpoints/arcface_synth/{OUT_NAME}/" in lines
