"""The port's mesh path (``facerec_torch/parallel/``) against the JAX
package's (``tests/test_parallel.py``): the mesh layout, padding and
per-rank slicing, the exact cross-shard top-k merge, data-parallel train
steps, the sharded serve step, and data-parallel ``train_model`` and
``evaluate_model``. JAX runs on its 8 virtual CPU devices; the port's ranks
are gloo processes on the CPU (``tests/torch_mp.py``)."""

from __future__ import annotations

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import torch_mp
from facerec_torch.config import MeshConfig, OptimizerConfig, TrainConfig
from facerec_torch.convert import from_jax
from facerec_torch.data.pipeline import local_slice, prefetch_to_device, shard_put
from facerec_torch.models.arcface import ArcFaceNet, dropout, init_like_flax
from facerec_torch.parallel import collectives as C
from facerec_torch.parallel import mesh as M
from facerec_torch.serve.gallery import GalleryStore
from facerec_tpu.config import MeshConfig as JaxMeshConfig
from facerec_tpu.config import ServeConfig as JaxServeConfig
from facerec_tpu.data.pipeline import local_slice as jax_local_slice
from facerec_tpu.detect.mtcnn import MTCNN as JaxMTCNN
from facerec_tpu.models import get_model as jax_get_model
from facerec_tpu.models.baseline import BaselineNet as JaxBaselineNet
from facerec_tpu.parallel.collectives import global_topk_merge as jax_global_topk_merge
from facerec_tpu.parallel.mesh import build_mesh as jax_build_mesh
from facerec_tpu.parallel.mesh import pad_to_multiple as jax_pad_to_multiple
from facerec_tpu.parallel.mesh import shard_batch as jax_shard_batch
from facerec_tpu.parallel.mesh import shard_params as jax_shard_params
from facerec_tpu.serve.pipeline import FacePipeline as JaxFacePipeline
from facerec_tpu.train import steps as jax_steps
from torch_zoo import jax_train_state, np_tree

SGD = dict(name="sgd", momentum=0.0, learning_rate=1e-2, use_grad_clip=False)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# -- layout ----------------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [dict(), dict(model_parallel=2), dict(model_parallel=4),
                                 dict(data_parallel=2, model_parallel=4),
                                 dict(data_parallel=8), dict(model_parallel=8)])
def test_build_mesh_layout_matches_jax(cfg):
    """Rank r sits where device r sits in JAX's mesh over 8 devices."""
    jm = jax_build_mesh(JaxMeshConfig(**cfg))
    where = {d.id: tuple(int(i) for i in ix) for ix, d in np.ndenumerate(jm.devices)}
    for rank, dev in enumerate(jax.devices()):
        mesh = M.build_mesh(MeshConfig(**cfg), world_size=8, rank=rank, device="cpu")
        assert mesh.shape == dict(jm.shape)
        assert mesh.coords == where[dev.id]
        assert mesh.groups == {"data": None, "model": None}  # layout only: no process group


@pytest.mark.parametrize("cfg", [dict(model_parallel=3), dict(data_parallel=3, model_parallel=2),
                                 dict(data_parallel=16)])
def test_build_mesh_errors_match_jax(cfg):
    with pytest.raises(ValueError):
        jax_build_mesh(JaxMeshConfig(**cfg))
    with pytest.raises(ValueError):
        M.build_mesh(MeshConfig(**cfg), world_size=8, rank=0, device="cpu")


def test_layout_only_mesh_refuses_collectives():
    mesh = M.build_mesh(MeshConfig(), world_size=2, rank=1, device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        C.psum(torch.ones(2), mesh)


@pytest.mark.parametrize("batch,multiple", [
    ({"x": np.ones((5, 3)), "y": np.arange(5)}, 8),
    ({"x": np.ones((8, 2))}, 8),
    ({"a": [np.arange(6).reshape(3, 2), np.arange(3)]}, 4),
])
def test_pad_to_multiple_matches_jax(batch, multiple):
    got, n = M.pad_to_multiple(batch, multiple)
    ref, n_ref = jax_pad_to_multiple(batch, multiple)
    assert n == n_ref
    for a, b in zip(M._leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("index,count", [(0, 1), (2, 4), (1, 2), (3, 4)])
def test_local_slice_matches_jax(index, count):
    batch = {"image": np.arange(16).reshape(16, 1), "label": np.arange(16)}
    got = local_slice(batch, process_index=index, process_count=count)
    ref = jax_local_slice(batch, process_index=index, process_count=count)
    for k in batch:
        np.testing.assert_array_equal(got[k], ref[k])


def test_batch_and_gallery_sharding_rows():
    mesh = M.build_mesh(MeshConfig(model_parallel=2), world_size=8, rank=5, device="cpu")
    assert mesh.coords == (2, 1)
    assert M.batch_sharding(mesh, 16) == slice(8, 12)
    assert M.gallery_sharding(mesh, 64) == slice(32, 64)
    assert M.replicated(mesh, 7) == slice(0, 7)
    with pytest.raises(ValueError):
        M.batch_sharding(mesh, 6)
    batch = {"x": np.arange(16).reshape(16, 1)}
    np.testing.assert_array_equal(M.shard_batch(batch, mesh)["x"].numpy(), batch["x"][8:12])
    put = shard_put(local_slice(batch, 2, 4), mesh)  # JAX's per-process form of the same
    assert put["x"].device == mesh.device
    np.testing.assert_array_equal(put["x"].numpy(), batch["x"][8:12])


def test_prefetch_slices_each_batch_by_data_index():
    mesh = M.build_mesh(MeshConfig(model_parallel=2), world_size=8, rank=3, device="cpu")
    batches = [{"x": np.arange(8) + 10 * i} for i in range(3)]
    got = [b["x"].numpy() for b in prefetch_to_device(iter(batches), mesh=mesh)]
    for i, g in enumerate(got):  # data index 1 of 4: rows 2-3
        np.testing.assert_array_equal(g, np.arange(2, 4) + 10 * i)


def test_initialize_distributed_env_gated(monkeypatch):
    """The JAX test's contract (tests/test_parallel.py): nothing set, no
    process group; the env vars reach ``init_process_group``; ``auto``
    defers to torchrun's ``env://``."""
    calls = []
    monkeypatch.setattr(M.dist, "init_process_group", lambda **kw: calls.append(kw))
    for var in ("FACEREC_COORDINATOR", "FACEREC_NUM_PROCESSES", "FACEREC_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert M.initialize_distributed() is False and not calls

    monkeypatch.setenv("FACEREC_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("FACEREC_NUM_PROCESSES", "4")
    monkeypatch.setenv("FACEREC_PROCESS_ID", "2")
    assert M.initialize_distributed() is True
    assert calls[-1] == {"backend": "nccl", "init_method": "tcp://10.0.0.1:1234",
                         "world_size": 4, "rank": 2}
    assert M.initialize_distributed(device="cpu", process_id=0) is True
    assert calls[-1]["backend"] == "gloo" and calls[-1]["rank"] == 0

    monkeypatch.setenv("FACEREC_COORDINATOR", "auto")
    assert M.initialize_distributed(backend="gloo") is True
    assert calls[-1] == {"backend": "gloo", "init_method": "env://"}


# -- the top-k merge -----------------------------------------------------------------------------


def _jax_merge(vals: np.ndarray, idx: np.ndarray, k: int):
    """JAX's ``global_topk_merge`` under ``shard_map`` over one model axis
    of ``len(vals)`` devices, each holding one shard's [..., k] slabs."""
    n = len(vals)
    mesh = JaxMesh(np.asarray(jax.devices()[:n]).reshape(1, n), ("data", "model"))

    def shard_fn(v, i):
        return jax_global_topk_merge(v[0], i[0], k, axis_name="model")

    fn = jax.shard_map(shard_fn, mesh=mesh, in_specs=(P("model"), P("model")),
                       out_specs=(P(), P(), P()), check_vma=False)
    return tuple(np.asarray(a) for a in fn(jnp.asarray(vals), jnp.asarray(idx)))


def test_sharded_gallery_topk_merge_matches_jax():
    """tests/test_parallel.py's case: 8 row shards of a gallery, each
    shard's top-k, merged: JAX's merge under shard_map, the port's
    ``merge_topk``, and the unsharded top-k agree."""
    from facerec_torch.ops.gallery import topk_stable

    rng = np.random.default_rng(0)
    n, d, rows, k = 8, 64, 16 * 8, 5
    gallery = rng.normal(size=(rows, d)).astype(np.float32)
    queries = rng.normal(size=(4, d)).astype(np.float32)
    per = rows // n
    local = [topk_stable(torch.from_numpy(queries @ gallery[s * per:(s + 1) * per].T), k)
             for s in range(n)]
    vals = np.stack([v.numpy() for v, _ in local])
    idx = np.stack([i.numpy().astype(np.int32) for _, i in local])
    jv, ji, js = _jax_merge(vals, idx, k)
    tv, ti, ts = C.merge_topk(torch.from_numpy(vals), torch.from_numpy(idx), k)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ts.numpy() * per + ti.numpy(), js * per + ji)
    ev, ei = jax.lax.top_k(jnp.asarray(queries @ gallery.T), k)
    np.testing.assert_allclose(tv.numpy(), np.asarray(ev), atol=1e-5)
    np.testing.assert_array_equal(ts.numpy() * per + ti.numpy(), np.asarray(ei))


def test_merge_keeps_lax_top_k_order_among_ties():
    """Ties across shards and the masked slots of short and empty shards go
    to the lower shard-major position, as JAX's merge gives them."""
    shards = [torch_mp.merge_shards(r) for r in range(4)]
    vals = np.stack([v for v, _ in shards])
    idx = np.stack([i for _, i in shards])
    jv, ji, js = _jax_merge(vals, idx, 3)
    tv, ti, ts = C.merge_topk(torch.from_numpy(vals), torch.from_numpy(idx), 3)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(ts.numpy(), js)
    # the second query: 0.3 of shard 0, then shard 1's 0.3, then shard 0's 0.2
    np.testing.assert_array_equal(js[1], [0, 1, 0])


def test_collectives_on_four_ranks(tmp_path):
    """psum (with its gradient), pmean, all_gather, ppermute_ring,
    reduce_scatter, axis_index and broadcast_object on a (2, 2) gloo mesh,
    and the tie case's merge through four ranks equal to JAX's."""
    out = torch_mp.run_ranks(torch_mp.collectives, 4, tmp_path)
    x = {r: np.array([r + 1, 10.0 * (r + 1)], np.float32) for r in range(4)}
    shards = [torch_mp.merge_shards(r) for r in range(4)]
    ref = _jax_merge(np.stack([v for v, _ in shards]), np.stack([i for _, i in shards]), 3)
    for r, o in enumerate(out):
        d, m = divmod(r, 2)
        data_peers = [m, 2 + m]  # ranks sharing model index m
        model_peers = [2 * d, 2 * d + 1]
        assert o["coords"] == (d, m) and o["axis_index"] == (d, m)
        np.testing.assert_array_equal(o["psum_data"], x[data_peers[0]] + x[data_peers[1]])
        np.testing.assert_array_equal(o["psum_grad"], [2.0, 4.0])  # both ranks' weights
        np.testing.assert_array_equal(o["pmean_model"], (x[model_peers[0]] + x[model_peers[1]]) / 2)
        np.testing.assert_array_equal(o["gather_tiled"], np.concatenate([x[p] for p in model_peers]))
        np.testing.assert_array_equal(o["gather_untiled"], np.stack([x[p] for p in data_peers])[None])
        np.testing.assert_array_equal(o["ring"], x[model_peers[(m - 1) % 2]])
        np.testing.assert_array_equal(o["ring_back"], x[data_peers[(d + 1) % 2]])
        full = sum(np.arange(4.0) * (p + 1) for p in data_peers)
        np.testing.assert_array_equal(o["scatter"], full[2 * d:2 * d + 2])
        assert o["object"] == {"rank": 0}
        for got, want in zip(o["merge"], ref):
            np.testing.assert_array_equal(got, want)


# -- data-parallel training ---------------------------------------------------------------------


def test_sync_batchnorm_matches_one_process(tmp_path):
    """Train-mode BatchNorm over a batch split on two ranks: the outputs,
    the input and parameter gradients and the running statistics of one
    process over the whole batch."""
    x = np.random.default_rng(5).normal(1.0, 2.0, (8, 6, 3, 3)).astype(np.float32)
    one = torch_mp.sync_batchnorm(0, 1, x)
    two = torch_mp.run_ranks(torch_mp.sync_batchnorm, 2, tmp_path, x)
    np.testing.assert_allclose(np.concatenate([t["y"] for t in two]), one["y"], atol=1e-5)
    np.testing.assert_allclose(np.concatenate([t["dx"] for t in two]), one["dx"], atol=1e-5)
    for t in two:
        for k in ("dw", "db", "mean", "var"):
            np.testing.assert_allclose(t[k], one[k], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("blocks", [1, 2])
def test_dropout_draws_the_global_mask(blocks):
    """Each data rank keeps its own rows of the mask one process draws for
    the whole batch (``blocks`` stacked batches, as the siamese twin pass
    stacks them)."""
    x = torch.ones(blocks * 8, 5)
    whole = dropout(x, 0.3, torch.Generator().manual_seed(4), blocks=blocks)
    for rank in range(4):
        mesh = M.build_mesh(MeshConfig(), world_size=4, rank=rank, device="cpu")
        local = torch.cat([x[b * 8 + 2 * rank:b * 8 + 2 * rank + 2] for b in range(blocks)])
        with M.data_parallel(mesh):
            got = dropout(local, 0.3, torch.Generator().manual_seed(4), blocks=blocks)
        want = torch.cat([whole[b * 8 + 2 * rank:b * 8 + 2 * rank + 2] for b in range(blocks)])
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _rel(got, ref, tol, name):
    assert abs(got - ref) <= tol * abs(ref), (name, got, ref)


def test_dp_gradients_match_jax_and_one_process(tmp_path):
    """tests/test_parallel.py's data-parallel step: the baseline model with
    BatchNorm, SGD, batch 16 at 16 px. The port on four gloo ranks against
    JAX's step sharded over its 8 devices, and against one port process,
    at JAX's bars (loss_sum rel 1e-4, parameters atol 1e-4)."""
    jm = JaxBaselineNet(num_classes=3, dropout_rate=0.0)
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(16, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, 3, 16).astype(np.int32),
             "mask": np.ones(16, np.float32)}
    v = jm.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                jnp.zeros((2, 16, 16, 3)), train=False)
    v = {"params": np_tree(v["params"]), "batch_stats": np_tree(v["batch_stats"])}
    mesh = jax_build_mesh(JaxMeshConfig())
    state = jax_shard_params(jax_train_state(v, "baseline", SGD), mesh)
    new, jmet = jax.jit(jax_steps.make_train_step(jm, "baseline"))(
        state, jax_shard_batch(batch, mesh))
    after = from_jax({"params": np_tree(new.params), "batch_stats": np_tree(new.batch_stats)},
                     "baseline")

    sd = from_jax(v, "baseline")
    one = torch_mp.dp_step(0, 1, sd, batch, SGD, "baseline", 3)
    ranks = torch_mp.run_ranks(torch_mp.dp_step, 4, tmp_path, sd, batch, SGD, "baseline", 3)
    for got in ranks:
        m = got["metrics"][0]
        _rel(m["loss_sum"], float(jmet["loss_sum"]), 1e-4, "loss_sum vs JAX")
        _rel(m["loss_sum"], one["metrics"][0]["loss_sum"], 1e-4, "loss_sum vs one process")
        assert m["count"] == 16.0 and m["correct"] == one["metrics"][0]["correct"]
        _rel(m["grad_norm"], one["metrics"][0]["grad_norm"], 1e-4, "grad_norm")
        for k, ref in after.items():
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got["state"][k], ref.numpy(), atol=1e-4, err_msg=k)
            np.testing.assert_allclose(got["state"][k], one["state"][k], atol=1e-4, err_msg=k)


def test_arcface_dropout_step_on_two_ranks_equals_one_process(tmp_path):
    """Two ArcFace steps with dropout on and BatchNorm over the global
    batch, on two ranks, against one process on the whole batch: the
    ranks draw the global batch's dropout masks."""
    from facerec_torch.data.datasets import _imagenet_normalize
    from facerec_torch.data.synthetic import make_synthetic_arrays

    imgs, labels = make_synthetic_arrays(num_classes=4, per_class=2, size=32, seed=3)
    batch = {"image": _imagenet_normalize(imgs), "label": labels.astype(np.int32),
             "mask": np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)}
    net = ArcFaceNet(num_classes=4, width=8, dropout_rate=0.2)
    init_like_flax(net, torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    opt = dict(name="sgd", momentum=0.9, learning_rate=0.05)
    one = torch_mp.dp_step(0, 1, sd, batch, opt, "arcface", 4, steps=2)
    two = torch_mp.run_ranks(torch_mp.dp_step, 2, tmp_path, sd, batch, opt, "arcface", 4, 2)
    for got in two:
        for m, ref in zip(got["metrics"], one["metrics"]):
            assert m["count"] == ref["count"] == 7.0 and m["correct"] == ref["correct"]
            _rel(m["loss_sum"], ref["loss_sum"], 1e-5, "loss_sum")
            _rel(m["grad_norm"], ref["grad_norm"], 1e-5, "grad_norm")
        for k, ref in one["state"].items():
            np.testing.assert_allclose(got["state"][k], ref, atol=1e-5, err_msg=k)
    # without the global mask (dropout off) the steps would differ from these
    assert one["metrics"][0]["loss_sum"] != one["metrics"][1]["loss_sum"]


def _train_cfg(**kw) -> TrainConfig:
    return TrainConfig(model_type="baseline", batch_size=8, image_size=32, epochs=2,
                       compute_dtype="float32", early_stopping=False, checkpoint_every=0,
                       prefetch_depth=1, seed=0,
                       optimizer=OptimizerConfig(name="sgd", momentum=0.9, learning_rate=0.05),
                       **kw)


def test_train_model_on_two_ranks_equals_one_process(synthetic_imagefolder, tmp_path):
    """``train_model`` over a (2, 1) mesh (batch 8: 4 per rank) against one
    process: the history, the test metrics and the parameters, within
    1e-5; rank 0 alone writes the run's files."""
    from facerec_torch.train.engine import train_model

    cfg = _train_cfg(mesh=MeshConfig(data_parallel=2))
    ranks = torch_mp.run_ranks(torch_mp.train, 2, tmp_path, str(synthetic_imagefolder),
                               str(tmp_path / "dp"), cfg.to_dict())
    one = train_model(cfg.replace(mesh=MeshConfig()), synthetic_imagefolder,
                      checkpoints_root=tmp_path / "one", model_name="one", device="cpu")
    for got in ranks:
        assert len(got["history"]) == len(one["history"]) == 2
        for a, b in zip(got["history"], one["history"]):
            for k in ("train_loss", "train_acc", "val_loss", "val_acc"):
                assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-6), k
        assert got["test_acc"] == one["test_acc"] and got["best_val_acc"] == one["best_val_acc"]
        assert got["test_loss"] == pytest.approx(one["test_loss"], rel=1e-5)
        for k, ref in one["model"].state_dict().items():
            # the running statistics within tests/torch_zoo.py's 1e-4: the
            # native kernel and the global batch's sums round the batch
            # variance differently (2e-5 of it here)
            tol = 1e-4 if k.endswith(("running_mean", "running_var")) else 1e-5
            np.testing.assert_allclose(got["state"][k], ref.numpy(), atol=tol, rtol=tol,
                                       err_msg=k)
    files = sorted(p.relative_to(tmp_path / "one" / "one").as_posix()
                   for p in (tmp_path / "one" / "one").rglob("*") if p.is_file())
    written = sorted(p.relative_to(tmp_path / "dp" / "dp").as_posix()
                     for p in (tmp_path / "dp" / "dp").rglob("*") if p.is_file())
    assert written == files


def test_evaluate_model_on_two_ranks_equals_one_process(synthetic_imagefolder, tmp_path):
    """``evaluate_model`` over two ranks (each its half of every batch)
    returns one process's metrics and predictions, and writes its files."""
    from facerec_torch.eval.engine import evaluate_model
    from facerec_torch.config import EvalConfig
    from facerec_torch.train.engine import train_model

    train_model(_train_cfg().replace(epochs=1), synthetic_imagefolder,
                checkpoints_root=tmp_path / "ck", model_name="m", device="cpu")
    ranks = torch_mp.run_ranks(torch_mp.evaluate, 2, tmp_path, str(synthetic_imagefolder),
                               str(tmp_path / "ck"), str(tmp_path / "dp"), "baseline")
    one = evaluate_model(EvalConfig(model_type="baseline", model_name="m", image_size=32,
                                    batch_size=6, compute_dtype="float32"),
                         synthetic_imagefolder, checkpoints_root=tmp_path / "ck",
                         outputs_root=tmp_path / "one", return_predictions=True, device="cpu")
    for got in ranks:
        for k in ("accuracy", "precision", "recall", "f1", "roc_auc", "pr_auc",
                  "num_test_images"):
            assert got[k] == pytest.approx(one[k], rel=1e-6), k
        assert got["per_class"] == one["per_class"] and got["confusion"] == one["confusion"]
        for k in ("y", "yhat"):
            np.testing.assert_array_equal(got["_predictions"][k], one["_predictions"][k])
        np.testing.assert_allclose(got["_predictions"]["probs"], one["_predictions"]["probs"],
                                   atol=1e-6)
    written = sorted(p.name for p in (tmp_path / "dp" / "m").iterdir())
    assert written == sorted(p.name for p in (tmp_path / "one" / "m").iterdir())


# -- serving ----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serve_ref():
    """tests/test_parallel.py's serve configuration through JAX's
    single-device pipeline: 37 gallery rows, 2 frames of 96 x 96, then
    ``p5`` removed. Returns the inputs and both results."""
    cfg = JaxServeConfig(max_faces=4, gallery_capacity=128, top_k=3, embed_size=32,
                         detection_threshold=0.0, recognition_threshold=10.0)
    det = JaxMTCNN((96, 96), min_face_size=24, max_faces=4, k_pnet=16, k_rnet=8)
    dp = det.init(jax.random.key(0))
    model = jax_get_model("baseline", num_classes=4)
    v = model.init({"params": jax.random.key(1), "dropout": jax.random.key(2)},
                   jnp.zeros((1, 32, 32, 3), jnp.float32), train=False)
    single = JaxFacePipeline(cfg, (96, 96), det, dp, lambda x: model.apply(v, x, method="embed"),
                             embed_dim=512)
    rng = np.random.default_rng(3)
    gallery = np.stack([rng.normal(size=512) for _ in range(37)]).astype(np.float32)
    for i, e in enumerate(gallery):
        single.gallery.add(f"p{i}", e)
    frames = rng.uniform(0, 255, (2, 96, 96, 3)).astype(np.float32)
    before = jax.device_get(single.process(frames))
    single.gallery.remove("p5")
    after = jax.device_get(single.process(frames))
    det_params = jax.tree_util.tree_map(np.asarray, dp)
    embed_state = from_jax({"params": np_tree(v["params"]),
                            "batch_stats": np_tree(v["batch_stats"])}, "baseline")
    return dict(det_params=det_params, embed_state=embed_state, gallery=gallery,
                frames=frames, before=before, after=after)


@pytest.mark.parametrize("data,model,capacity", [(2, 2, 64), (1, 4, 128)])
def test_sharded_serve_matches_jax(serve_ref, tmp_path, data, model, capacity):
    """The port's serve step on a (data, model) mesh of four gloo ranks:
    frames split over data, gallery rows over model (rows on both sides of
    a shard boundary), the merged matches equal to JAX's single-device
    step's, before and after ``remove("p5")`` moves rows across the
    boundaries (the JAX test's bars)."""
    ref = serve_ref
    # as in the JAX test every slot is matched, valid or not (its random
    # detector finds no face in noise); the best rows lie past the first
    # shard of 32 rows, so the merge has to pick another shard's candidates
    assert (np.asarray(ref["before"].match_indices) >= 32).all()
    ranks = torch_mp.run_ranks(torch_mp.serve, 4, tmp_path, data, model, capacity,
                               ref["det_params"], ref["embed_state"], ref["gallery"],
                               ref["frames"], "p5")
    per = 2 // data
    rows = capacity // model
    for got in ranks:
        d, m = got["coords"]
        assert got["local_count"] == min(max(37 - m * rows, 0), rows)
        for key in ("before", "after"):
            r, j = got[key], ref[key]
            sl = slice(d * per, (d + 1) * per)
            np.testing.assert_array_equal(r["valid"], np.asarray(j.valid)[sl])
            np.testing.assert_array_equal(r["match_indices"], np.asarray(j.match_indices)[sl])
            np.testing.assert_allclose(r["match_scores"], np.asarray(j.match_scores)[sl],
                                       atol=1e-5)
            np.testing.assert_allclose(r["embeddings"], np.asarray(j.embeddings)[sl], atol=1e-4)
    # the shards after the remove hold the one-process rows: p5's row gone,
    # every later row one slot down, across the boundaries
    one = GalleryStore(capacity=capacity, dim=512, dtype="bfloat16", device="cpu")
    for i, e in enumerate(ref["gallery"]):
        one.add(f"p{i}", e)
    one.remove("p5")
    want = one.embeddings.float().numpy()
    for got in ranks:
        lo = got["lo"]
        np.testing.assert_array_equal(got["rows"], want[lo:lo + rows])


def test_sharded_gallery_mutations_match_one_process(tmp_path):
    """add, add_many, add_many_device, remove (inside a shard, across a
    boundary, the last row, the first row), rename, save and load on a
    gallery sharded over four ranks give one process's rows, names and
    file."""
    rows = np.random.default_rng(9).normal(size=(13, 8)).astype(np.float32)
    capacity = 16
    ranks = torch_mp.run_ranks(torch_mp.gallery_ops, 4, tmp_path, capacity, rows,
                               str(tmp_path / "sharded"))
    one = GalleryStore(capacity=capacity, dim=8, device="cpu")
    n = len(rows)
    one.add("a0", rows[0])
    one.add_many([f"a{i}" for i in range(1, n // 2)], rows[1:n // 2])
    one.add_many_device([f"a{i}" for i in range(n // 2, n)], torch.from_numpy(rows[n // 2:]))
    for name in ("a1", f"a{capacity // 4}", f"a{n - 1}", "a0"):
        one.remove(name)
    one.rename("a2", "renamed")
    one.save(tmp_path / "one")
    full = one.embeddings.numpy()
    # add_many_device normalises only the rows a shard keeps: the CPU's norm
    # kernel then blocks the same row's sum another way (up to 2 ulps)
    for r, got in enumerate(ranks):
        assert got["names"] == one.names and got["count"] == one.count == 9
        np.testing.assert_allclose(got["rows"], full[4 * r:4 * r + 4], rtol=0, atol=1e-7)
        assert got["local_count"] == got["local_count_device"] == min(max(9 - 4 * r, 0), 4)
        np.testing.assert_allclose(got["loaded_rows"], full[4 * r:4 * r + 4], rtol=0, atol=1e-7)
        assert got["loaded_names"] == one.names
    saved = pickle.loads((tmp_path / "sharded" / "face_references.pkl").read_bytes())
    ref = pickle.loads((tmp_path / "one" / "face_references.pkl").read_bytes())
    assert list(saved) == list(ref)
    for k in ref:
        np.testing.assert_allclose(saved[k], ref[k], rtol=0, atol=1e-7)


def test_rotation_on_data_shards_equals_the_whole():
    """K2's plain path (the CPU wrapper) on each data shard's patches equals
    the whole batch's, as JAX's Pallas kernel under shard_map equals its
    single-device call; and it agrees with the Pallas kernel (interpret
    mode) as tests/test_parallel.py holds the kernel against XLA."""
    from facerec_torch.ops.warp_kernel import rotate_patches_kernel
    from facerec_tpu.ops.pallas_warp import rotate_patches_pallas

    n, p, out = 16, 48, 32
    rng = np.random.default_rng(0)
    patches = rng.uniform(0, 1, (n, p, p, 3)).astype(np.float32)
    angles = rng.uniform(-0.2, 0.2, n).astype(np.float32)
    centers = rng.uniform(p / 2 - 3, p / 2 + 3, (n, 2)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (patches, angles, centers)]
    whole = rotate_patches_kernel(*args, out)
    for dp in (2, 4, 8):
        per = n // dp
        shards = [rotate_patches_kernel(*(a[i * per:(i + 1) * per] for a in args), out)
                  for i in range(dp)]
        torch.testing.assert_close(torch.cat(shards), whole, rtol=0, atol=0)
    pallas = np.asarray(rotate_patches_pallas(jnp.asarray(patches), jnp.asarray(angles),
                                              jnp.asarray(centers), out, interpret=True))
    np.testing.assert_allclose(whole.float().numpy(), pallas.astype(np.float32), atol=2e-2)


def test_pipeline_upload_sends_this_ranks_frames():
    """With a mesh the pipeline uploads only its data slice of the batch."""
    from facerec_torch.config import ServeConfig
    from facerec_torch.serve.pipeline import FacePipeline

    mesh = M.build_mesh(MeshConfig(data_parallel=2), world_size=2, rank=1, device="cpu")
    pipe = FacePipeline(ServeConfig(gallery_capacity=8), (8, 8), None, None, mesh=mesh)
    frames = np.arange(4 * 8 * 8 * 3, dtype=np.uint8).reshape(4, 8, 8, 3)
    np.testing.assert_array_equal(pipe.upload(frames).numpy(), frames[2:])
    assert pipe.gallery.embeddings.shape == (8, 512)  # model size 1: every row
