"""The port's embedding visualizer (``facerec_torch/eval/visualizer.py``)
against the JAX package's (``facerec_tpu/eval/visualizer.py``) on the CPU:
PCA up to the sign of each component, the projection with sklearn's t-SNE
and without it, the embeddings from the same weights, and the exported
CSVs."""

import csv
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_torch.convert import from_jax
from facerec_torch.data.datasets import ImageFolderIndex
from facerec_torch.models.baseline import BaselineNet
from facerec_torch.eval import visualizer as V
from facerec_tpu.data.datasets import ImageFolderIndex as JaxImageFolderIndex
from facerec_tpu.eval import visualizer as JV
from facerec_tpu.models.baseline import BaselineNet as JaxBaselineNet
from torch_zoo import np_tree, random_stats

EMBED_ATOL = 1e-4  # f32 embeddings, port against JAX
SIM_ATOL = 1e-4  # the similarity matrix's entries


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("n,d,k", [(20, 8, 3), (50, 64, 10), (12, 512, 11)])
def test_pca_matches_jax_up_to_sign(n, d, k):
    x = np.random.default_rng(n).normal(size=(n, d))
    got, want = V.pca(x, k), JV.pca(x, k)
    assert got.shape == want.shape == (n, k)
    signs = np.sign((got * want).sum(0))
    np.testing.assert_allclose(got * signs, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("sklearn", ["present", "absent"])
def test_project_embeddings_matches_jax(dims, sklearn, monkeypatch):
    """The same 40 x 64 array through both: t-SNE where sklearn imports
    (the same call, the same result), the PCA projection where it does
    not; ``projection_kind`` names which."""
    if sklearn == "absent":
        monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    else:
        pytest.importorskip("sklearn.manifold")
    emb = np.random.default_rng(dims).normal(size=(40, 64)).astype(np.float32)
    got, want = V.project_embeddings(emb, dims, seed=1), JV.project_embeddings(emb, dims, seed=1)
    assert got.shape == (40, dims)
    np.testing.assert_array_equal(got, want)
    assert V.projection_kind() == ("tsne" if sklearn == "present" else "pca")
    if sklearn == "absent":
        np.testing.assert_array_equal(got, V.pca(emb, 39)[:, :dims])


@pytest.fixture(scope="module")
def models():
    """A JAX baseline (f32) with random BatchNorm statistics and the port's
    baseline carrying its weights."""
    jnet = JaxBaselineNet(num_classes=4, dropout_rate=0.0)
    v = jax.jit(functools.partial(jnet.init, train=False))(
        {"params": jax.random.key(8), "dropout": jax.random.key(9)}, jnp.zeros((1, 32, 32, 3)))
    v = {"params": np_tree(v["params"]), "batch_stats": random_stats(v["batch_stats"], 10)}
    net = BaselineNet(num_classes=4)
    net.load_state_dict(from_jax(v, "baseline"))
    return jnet, v, net


def test_extract_embeddings_matches_jax(models, synthetic_imagefolder):
    """Every test image's 512-d embedding at 32 px, in the split's order,
    within ``EMBED_ATOL``; ``max_samples`` cuts both the same way."""
    jnet, v, net = models
    root = synthetic_imagefolder / "test"
    for max_samples in (300, 3):
        emb, lab, names = V.EmbeddingVisualizer(net, "baseline", 32, max_samples=max_samples,
                                                batch_size=2, compute_dtype="float32",
                                                device="cpu").extract_embeddings(
            ImageFolderIndex.build(root))
        jemb, jlab, jnames = JV.EmbeddingVisualizer(jnet, v, "baseline", 32, max_samples=max_samples,
                                                    batch_size=2).extract_embeddings(
            JaxImageFolderIndex.build(root))
        assert emb.dtype == np.float32 and emb.shape == np.asarray(jemb).shape
        np.testing.assert_allclose(emb, np.asarray(jemb, np.float32), atol=EMBED_ATOL, rtol=0)
        np.testing.assert_array_equal(lab, jlab)
        assert names == jnames
    assert not net.training


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_export_csvs_match_jax(monkeypatch, tmp_path):
    """The same embeddings (30 of 64 dims, 5 people) through each
    package's ``export``: the same files and headers, the same t-SNE or PCA
    rows, and the similarity matrix within ``SIM_ATOL``."""
    rng = np.random.default_rng(4)
    lab = np.repeat(np.arange(5), 6).astype(np.int32)
    emb = (rng.normal(size=(30, 64)) + 3 * rng.normal(size=(5, 64))[lab]).astype(np.float32)
    names = [f"person_{i}" for i in range(6)]  # the sixth has no images
    monkeypatch.setattr(V.EmbeddingVisualizer, "extract_embeddings", lambda self, index: (emb, lab, names))
    monkeypatch.setattr(JV.EmbeddingVisualizer, "extract_embeddings", lambda self, index: (emb, lab, names))
    got = V.EmbeddingVisualizer(None, "baseline", device="cpu").export(None, tmp_path / "port")
    want = JV.EmbeddingVisualizer(None, None, "baseline").export(None, tmp_path / "jax")
    assert got.keys() == want.keys() and got["num_embeddings"] == want["num_embeddings"] == 30
    for name in ("tsne_2d.csv", "tsne_3d.csv"):
        assert _read(tmp_path / "port" / name) == _read(tmp_path / "jax" / name)
    p, j = _read(tmp_path / "port" / "similarity_matrix.csv"), _read(tmp_path / "jax" / "similarity_matrix.csv")
    assert p[0] == j[0] == [""] + names[:5]
    assert [r[0] for r in p] == [r[0] for r in j]
    np.testing.assert_allclose(np.asarray([r[1:] for r in p[1:]], float),
                               np.asarray([r[1:] for r in j[1:]], float), atol=SIM_ATOL, rtol=0)


def test_report_from_weights_matches_jax(models, synthetic_imagefolder, tmp_path):
    """``generate_visualization_report`` end to end from the same weights:
    the same files, the same labels and persons in each row, the
    similarity matrix within ``SIM_ATOL`` (the projections' coordinates are
    not compared: t-SNE moves a lot on last-bit differences)."""
    jnet, v, net = models
    test_dir = synthetic_imagefolder / "test"
    got = V.generate_visualization_report(net, "baseline", test_dir, image_size=32,
                                          out_dir=tmp_path / "port", compute_dtype="float32",
                                          device="cpu")
    want = JV.generate_visualization_report(jnet, v, "baseline", test_dir, image_size=32,
                                            out_dir=tmp_path / "jax")
    assert got["num_embeddings"] == want["num_embeddings"] == len(ImageFolderIndex.build(test_dir))
    for name in ("tsne_2d.csv", "tsne_3d.csv"):
        p, j = _read(tmp_path / "port" / name), _read(tmp_path / "jax" / name)
        assert p[0] == j[0] and [r[-2:] for r in p] == [r[-2:] for r in j]
    p, j = _read(tmp_path / "port" / "similarity_matrix.csv"), _read(tmp_path / "jax" / "similarity_matrix.csv")
    assert p[0] == j[0]
    np.testing.assert_allclose(np.asarray([r[1:] for r in p[1:]], float),
                               np.asarray([r[1:] for r in j[1:]], float), atol=SIM_ATOL, rtol=0)
