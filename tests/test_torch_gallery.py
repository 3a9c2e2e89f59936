"""Parity of the port's match stage with the JAX package on the CPU:
``facerec_torch.ops.gallery`` against ``gallery_topk_xla`` (and, for the card
path's query rounding, against the Pallas kernel in interpret mode) and
``facerec_torch.serve.gallery.GalleryStore`` against the JAX store, including
the on-disk format in both directions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_torch.ops import kernels
from facerec_torch.ops.gallery import (bf16_rows_per_split, bf16_splits, cosine_to_euclidean,
                                       gallery_topk, gallery_topk_plain)
from facerec_torch.serve.gallery import GalleryStore
from facerec_tpu.ops.gallery import cosine_to_euclidean as jax_c2e
from facerec_tpu.ops.gallery import gallery_topk_pallas, gallery_topk_xla
from facerec_tpu.serve.gallery import GalleryStore as JaxGalleryStore


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _f32_case():
    """The inputs of tests/test_ops.py::test_gallery_topk_pallas_matches_xla."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(17, 256)).astype(np.float32)
    g = rng.normal(size=(1024, 256)).astype(np.float32)
    g[3] = q[0] + 0.01 * rng.normal(size=256)
    g[3 + 512] = q[0] + 0.01 * rng.normal(size=256)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    return q, g


def _bf16_case():
    """The inputs of tests/test_ops.py::test_gallery_topk_bf16_storage."""
    rng = np.random.default_rng(2)
    centers = rng.normal(size=(32, 256)).astype(np.float32)
    g = np.repeat(centers, 32, axis=0) + 0.05 * rng.normal(size=(1024, 256)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = centers + 0.05 * rng.normal(size=centers.shape).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q, g


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 2e-3)])
@pytest.mark.parametrize("count", [700, 1000, 3, 0])
def test_gallery_topk_matches_xla(dtype, atol, count):
    q, g = _f32_case() if dtype == "float32" else _bf16_case()
    gj = jnp.asarray(g, getattr(jnp, dtype))
    v0, i0 = gallery_topk_xla(jnp.asarray(q), gj, count, k=5)
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).to(getattr(torch, dtype))
    v1, i1 = gallery_topk(torch.from_numpy(q), gt, torch.tensor(count, dtype=torch.int32), k=5)
    v0, i0 = np.asarray(v0), np.asarray(i0)
    valid = np.arange(5) < min(count, 5)
    np.testing.assert_array_equal(i1.numpy()[:, valid], i0[:, valid])
    np.testing.assert_allclose(v1.numpy()[:, valid], v0[:, valid], atol=atol, rtol=0)
    # the masked slots too: -1e30 at the lowest masked rows, as lax.top_k
    np.testing.assert_array_equal(i1.numpy(), i0)
    np.testing.assert_array_equal(v1.numpy()[:, ~valid], v0[:, ~valid])
    assert int(i1.max()) < max(count, 5)
    np.testing.assert_allclose(cosine_to_euclidean(v1).numpy()[:, valid],
                               np.asarray(jax_c2e(jnp.asarray(v0)))[:, valid], atol=1e-3)


@pytest.mark.parametrize("count", [700, 1000, 3, 0])
def test_card_rounding_matches_pallas(count):
    """On the card the bf16 kernel rounds the queries to bf16 before the
    product, as ``gallery_topk_pallas`` casts them to the gallery dtype: the
    plain version fed rounded queries is that arithmetic, held here against
    the Pallas kernel (interpret mode, as tests/test_ops.py runs it). Pallas
    returns its scores quantised down by at most 2^-18 and so ties rows
    whose scores lie within one quantum (ties to the lower index); where the
    two orders differ, the plain scores of the two rows lie that close.
    Pallas leaves the indices of empty slots at 0; the values compare."""
    q, g = _bf16_case()
    gj = jnp.asarray(g, jnp.bfloat16)
    v1, i1 = gallery_topk_pallas(jnp.asarray(q), gj, count, k=5, interpret=True)
    v1, i1 = np.asarray(v1), np.asarray(i1)
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).to(torch.bfloat16)
    qt = torch.from_numpy(q)
    v0, i0 = gallery_topk_plain(qt.to(torch.bfloat16), gt, count, k=5)
    v0, i0 = v0.numpy(), i0.numpy()
    valid = np.arange(5) < min(count, 5)
    quantum = 2.0 ** -18
    np.testing.assert_allclose(v1, v0, atol=quantum + 1e-6, rtol=0)
    scores = (qt.to(torch.bfloat16).float() @ gt.float().T).numpy()
    rows = np.arange(q.shape[0])[:, None]
    differ = (i1 != i0) & valid
    assert np.all(np.abs(scores[rows, i1] - scores[rows, i0])[differ] <= quantum)
    assert differ.sum() <= 0.05 * differ.size
    # the rounding is what makes them agree: f32 queries miss by ~1e-3
    vf, _ = gallery_topk_plain(qt, gt, count, k=5)
    if count:
        assert np.abs(vf.numpy() - v1)[:, valid].max() > 1e-5


@pytest.mark.parametrize("b,g,count", [(384, 1024, 512), (384, 131072, 65536),
                                       (384, 1048576, 524288), (37, 1048576, 524287)])
def test_bf16_splits_cover_the_prefix(b, g, count):
    """The bf16 kernel's grid: one wave (query tiles x splits <= 132 SMs),
    splits of whole 128-row tiles cut from the valid prefix on the device,
    which together cover it, and at production sizes fill the card."""
    nsplit = bf16_splits(b, g, sms=132)
    per = bf16_rows_per_split(count, nsplit)
    qtiles = -(-b // 128)
    assert per % 128 == 0 and per > 0
    assert qtiles * nsplit <= 132 and nsplit <= -(-g // 128)
    assert nsplit * per >= count and per - 128 < -(-count // nsplit)
    active = -(-count // per)
    if g >= 131072:
        assert qtiles * active >= 0.95 * 132


def test_k1_breakdown_finds_the_epilogue():
    """The breakdown tool skips the bf16 kernel's per-tile epilogue by
    editing the shipped source; it must still find the place."""
    from facerec_torch.k1_breakdown import _variants

    v = _variants()
    assert v["no_epilogue"] != v["shipped"]
    assert "if (count >= 0) continue;" in v["no_epilogue"]


def test_gallery_topk_ties_go_to_lower_index():
    g = np.zeros((64, 8), np.float32)
    g[[5, 9, 40, 41, 63], 0] = 1.0  # five identical best rows
    q = np.eye(8, dtype=np.float32)[:2]
    _, i0 = gallery_topk_xla(jnp.asarray(q), jnp.asarray(g), 64, k=5)
    _, i1 = gallery_topk_plain(torch.from_numpy(q), torch.from_numpy(g), 64, k=5)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i0))
    np.testing.assert_array_equal(i1.numpy()[0], [5, 9, 40, 41, 63])


def test_gallery_topk_cpu_takes_plain_version():
    q, g = _f32_case()
    before = kernels.launches()
    v1, i1 = gallery_topk(torch.from_numpy(q), torch.from_numpy(g), 700, k=5)
    v2, i2 = gallery_topk_plain(torch.from_numpy(q), torch.from_numpy(g), 700, k=5)
    assert kernels.launches() == before
    assert torch.equal(i1, i2) and torch.equal(v1, v2)


def _enroll_both(dtype):
    rng = np.random.default_rng(4)
    embs = rng.normal(size=(6, 32)).astype(np.float32)
    jax_store = JaxGalleryStore(capacity=8, dim=32, dtype=getattr(jnp, dtype))
    port = GalleryStore(capacity=8, dim=32, dtype=dtype, device="cpu")
    for store in (jax_store, port):
        store.add_many([f"p{i}" for i in range(4)], embs[:4])
        store.add("p4", embs[4])
        store.add("p5", embs[5])
        assert store.remove("p1") and not store.remove("nobody")
        assert store.rename("p2", "q2") and not store.rename("nobody", "x")
    return jax_store, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gallery_store_matches_jax(dtype):
    jax_store, port = _enroll_both(dtype)
    assert port.names == jax_store.names == ["p0", "q2", "p3", "p4", "p5"]
    assert port.count == jax_store.count == int(port.count_device) == 5
    assert port.count_device.dtype == torch.int32
    np.testing.assert_allclose(port.embeddings.float().numpy(),
                               np.asarray(jax_store.embeddings.astype(jnp.float32)), atol=1e-6)
    assert port.name_of(1) == "q2" and port.name_of(5) == "Unknown" and port.name_of(-1) == "Unknown"
    port.clear()
    assert port.count == 0 and int(port.count_device) == 0 and not port.embeddings.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gallery_add_many_device_matches_jax(dtype):
    """Enrollment from device-resident rows, normalised in f32 on the
    device: names, counts and rows as the JAX store's ``add_many_device``
    (bf16 rows within one ulp: the two f32 norms may differ in the last
    bit before rounding)."""
    rng = np.random.default_rng(5)
    embs = rng.normal(size=(5, 32)).astype(np.float32) * 3.0
    jax_store = JaxGalleryStore(capacity=8, dim=32, dtype=getattr(jnp, dtype))
    port = GalleryStore(capacity=8, dim=32, dtype=dtype, device="cpu")
    jax_store.add("first", embs[0])
    port.add("first", embs[0])
    names = [f"d{i}" for i in range(4)]
    assert jax_store.add_many_device(names, jnp.asarray(embs[1:])) == [1, 2, 3, 4]
    assert port.add_many_device(names, torch.from_numpy(embs[1:])) == [1, 2, 3, 4]
    assert port.add_many_device([], torch.zeros(0, 32)) == []
    assert port.names == jax_store.names == ["first", *names]
    assert port.count == jax_store.count == int(port.count_device) == 5
    ref = np.asarray(jax_store.embeddings.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(port.embeddings.numpy(), ref, atol=1e-6)
    else:
        bits = port.embeddings.view(torch.int16).numpy().astype(np.int32)
        ref_bits = np.asarray(jax_store.embeddings).view(np.int16).astype(np.int32)
        assert np.abs(bits - ref_bits).max() <= 1
    np.testing.assert_allclose(np.linalg.norm(port.embeddings.float().numpy()[:5], axis=1), 1.0,
                               atol=1e-2)
    with pytest.raises(ValueError, match="expected"):
        port.add_many_device(["x"], torch.zeros(1, 16))
    with pytest.raises(ValueError, match="gallery full"):
        port.add_many_device([f"y{i}" for i in range(4)], torch.ones(4, 32))


def test_gallery_save_load_both_directions(tmp_path):
    jax_store, port = _enroll_both("float32")
    port.save(tmp_path / "from_port")
    jax_store.save(tmp_path / "from_jax")
    back_jax = JaxGalleryStore.load(tmp_path / "from_port", capacity=8)
    back_port = GalleryStore.load(tmp_path / "from_jax", capacity=8, device="cpu")
    assert back_jax.names == back_port.names == port.names
    np.testing.assert_allclose(np.asarray(back_jax.embeddings), port.embeddings.numpy(), atol=1e-6)
    np.testing.assert_allclose(back_port.embeddings.numpy(),
                               np.asarray(jax_store.embeddings), atol=1e-6)
    empty = GalleryStore.load(tmp_path / "missing", capacity=4, device="cpu")
    assert empty.count == 0 and empty.embeddings.shape == (4, 512)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gallery_loads_the_reference_list_pickle(tmp_path, dtype):
    """The original reference app's ``face_references.pkl``: a list of
    ``{"name", "embedding_numpy" [1, 512], "image_path"}`` dicts, a name
    repeated as its own row (the JAX package reads only its dict format).
    The rows are those of the same gallery saved as a dict; ``save`` still
    writes the dict, which JAX's ``load`` reads."""
    import pickle

    rng = np.random.default_rng(5)
    names = ["ann", "ben", "ann", "cy"]
    embs = rng.normal(size=(4, 1, 512)).astype(np.float32)
    refs = [{"name": n, "embedding_numpy": e, "image_path": f"face_references/{n}_{i}.jpg"}
            for i, (n, e) in enumerate(zip(names, embs))]
    (tmp_path / "ref").mkdir()
    (tmp_path / "ref" / "face_references.pkl").write_bytes(pickle.dumps(refs))
    store = GalleryStore.load(tmp_path / "ref", capacity=8, dtype=dtype, device="cpu")
    assert store.names == names and store.count == 4
    want = GalleryStore(capacity=8, dtype=dtype, device="cpu")
    want.add_many(names, embs.reshape(4, 512))
    assert torch.equal(store.embeddings, want.embeddings)
    store.save(tmp_path / "out")
    saved = pickle.loads((tmp_path / "out" / "face_references.pkl").read_bytes())
    assert isinstance(saved, dict) and list(saved) == ["ann", "ben", "cy"]
    back = JaxGalleryStore.load(tmp_path / "out", capacity=8)
    assert back.names == ["ann", "ben", "cy"]
