"""``facerec_torch/multichip.py`` against the root ``__graft_entry__.py``:
the single-card forward, the dry run's train and serve steps on a
four-rank mesh (gloo ranks on the CPU, ``tests/torch_mp.py``) against JAX's
on four of its virtual CPU devices, the decision whether a mesh's steps are
captured, and the refusal of a layout whose cards are missing."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import __graft_entry__
import torch_mp
from facerec_torch import multichip
from facerec_torch.config import MeshConfig
from facerec_torch.convert import from_jax
from facerec_torch.parallel import mesh as M
from facerec_tpu.config import MeshConfig as JaxMeshConfig
from facerec_tpu.config import OptimizerConfig as JaxOptimizerConfig
from facerec_tpu.config import ServeConfig as JaxServeConfig
from facerec_tpu.config import TrainConfig as JaxTrainConfig
from facerec_tpu.detect.mtcnn import MTCNN as JaxMTCNN
from facerec_tpu.models import get_model as jax_get_model
from facerec_tpu.models.arcface import ArcFaceNet as JaxArcFaceNet
from facerec_tpu.serve.pipeline import FacePipeline as JaxFacePipeline
from facerec_tpu.train.state import create_train_state as jax_create_train_state
from facerec_tpu.train.steps import make_train_step as jax_make_train_step
from torch_zoo import np_tree

N = 4  # ranks, and JAX's devices
LR = 1e-3  # the dry run's AdamW learning rate


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_entry_matches_graft_entry():
    """The port's forward against ``__graft_entry__.entry()``'s on seeded
    normal input, JAX's initial weights carried over by ``from_jax``, at
    tests/test_torch_embed.py's bf16 bar (1 - cos < 1e-2)."""
    fn, (x0,) = __graft_entry__.entry()
    assert x0.shape == (8, 112, 112, 3)
    model = jax_get_model("arcface", num_classes=18, compute_dtype="bfloat16")
    v = model.init({"params": jax.random.key(0), "dropout": jax.random.key(1)}, x0,
                   labels=jnp.zeros(8, jnp.int32), train=True)  # entry()'s weights
    x = np.random.default_rng(0).normal(size=(8, 112, 112, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(fn)(jnp.asarray(x)), np.float32)
    forward, (example,) = multichip.entry(device="cpu", weights=from_jax(np_tree(v), "arcface"))
    assert tuple(example.shape) == (8, 112, 112, 3)
    got = forward(torch.from_numpy(x)).float().numpy()
    assert got.shape == ref.shape == (8, 512)
    cos = np.sum(got * ref, axis=1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    assert np.all(1.0 - cos < 1e-2), 1.0 - cos


def _jax_dryrun(mp: int) -> dict:
    """``__graft_entry__.dryrun_multichip(4)``'s steps on a (4 / mp, mp) mesh
    of JAX's first four devices, the ArcFace dropout off: its initial
    weights, the train step's metrics and parameters, the serve result."""
    devices = jax.devices()[:N]
    mesh = JaxMesh(np.asarray(devices).reshape(N // mp, mp), ("data", "model"))
    batch = {"image": np.random.default_rng(0).normal(size=(N * 2, 64, 64, 3)).astype(np.float32),
             "label": np.arange(N * 2, dtype=np.int32) % 4,
             "mask": np.ones(N * 2, np.float32)}
    config = JaxTrainConfig(model_type="arcface", batch_size=N * 2, image_size=64, num_classes=4,
                            optimizer=JaxOptimizerConfig(name="adamw", amsgrad=True,
                                                         learning_rate=1e-3),
                            mesh=JaxMeshConfig(data_parallel=N // mp, model_parallel=mp),
                            compute_dtype="float32")
    model = JaxArcFaceNet(num_classes=4, dropout_rate=0.0)
    state = jax_create_train_state(model, batch, config, "arcface", jax.random.key(0))
    init_arc = {"params": np_tree(state.params), "batch_stats": np_tree(state.batch_stats)}
    state = jax.device_put(state, NamedSharding(mesh, P()))
    sharded = {k: jax.device_put(v, NamedSharding(mesh, P("data", *([None] * (v.ndim - 1)))))
               for k, v in batch.items()}
    new, metrics = jax.jit(jax_make_train_step(model, "arcface"))(state, sharded)
    stats = np_tree(new.batch_stats)
    after = from_jax({"params": np_tree(new.params), "batch_stats": stats}, "arcface")
    # AdamW's first moment after one step: 0.1 x the (clipped) gradient
    mu = next(s.mu for s in jax.tree_util.tree_leaves(
        new.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
    grads = from_jax({"params": np_tree(mu), "batch_stats": stats}, "arcface")

    scfg = JaxServeConfig(max_faces=2, gallery_capacity=32 * mp, top_k=3, embed_size=32,
                          detection_threshold=0.0, recognition_threshold=10.0)
    det = JaxMTCNN((64, 64), min_face_size=24, max_faces=2, k_pnet=8, k_rnet=4)
    det_params = det.init(jax.random.key(0))
    serve_model = jax_get_model("baseline", num_classes=4)
    sv = serve_model.init({"params": jax.random.key(1), "dropout": jax.random.key(2)},
                          jnp.zeros((1, 32, 32, 3), jnp.float32), train=False)
    pipe = JaxFacePipeline(scfg, (64, 64), det, det_params,
                           lambda variables, x: serve_model.apply(variables, x, method="embed"),
                           embed_dim=512, embed_variables=sv, mesh=mesh)
    rng = np.random.default_rng(0)
    for i in range(5):
        pipe.gallery.add(f"id_{i}", rng.normal(size=512))
    frames = rng.uniform(0, 255, (N // mp, 64, 64, 3)).astype(np.float32)
    result = jax.device_get(pipe.process(frames))
    init = {"arcface": from_jax(init_arc, "arcface"),
            "detector": jax.tree_util.tree_map(np.asarray, det_params),
            "embedder": from_jax({"params": np_tree(sv["params"]),
                                  "batch_stats": np_tree(sv["batch_stats"])}, "baseline")}
    return {"init": init, "metrics": {k: float(v) for k, v in metrics.items()}, "after": after,
            "grads": grads, "serve": result}


@pytest.mark.parametrize("mp", [2, 1], ids=["2x2", "4x1"])
def test_dryrun_multichip_matches_jax(tmp_path, mp):
    """``dryrun_multichip(4)`` in four gloo ranks against JAX's dry-run steps
    at the same configuration on four virtual devices: the loss and
    grad_norm (relative 1e-4) and the parameters after the AdamW step
    (1e-4), as tests/test_torch_parallel.py holds its data-parallel step;
    the serve step's matched rows equal to JAX's for each rank's frame.
    AdamW divides each gradient element by its own magnitude, so where the
    gradient lies within the gradient bar of 0 (1e-4 of its tensor's
    largest, tests/test_torch_train.py's) its sign is not determined and
    the two steps may differ by up to twice the learning rate there."""
    ref = _jax_dryrun(mp)
    ranks = torch_mp.run_ranks(torch_mp.dryrun, N, tmp_path, mp, ref["init"], timeout=240)
    jm = ref["metrics"]
    for rank, got in enumerate(ranks):
        d, m = divmod(rank, mp)
        assert got["coords"] == (d, m) and got["shape"] == {"data": N // mp, "model": mp}
        assert not got["capturable"]  # gloo groups: the steps stay eager
        tm = got["metrics"]
        assert tm["count"] == jm["count"] == N * 2
        assert tm["loss_sum"] == pytest.approx(jm["loss_sum"], rel=1e-4)
        assert tm["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-4)
        for k, want in ref["after"].items():
            if k.endswith("num_batches_tracked"):
                continue
            want = want.numpy()
            diff = np.abs(got["state"][k] - want)
            undetermined = np.zeros(want.shape, bool)
            if k in ref["grads"] and not k.endswith(("running_mean", "running_var")):
                g = np.abs(ref["grads"][k].numpy())
                undetermined = g <= 1e-4 * g.max()
            assert (diff[~undetermined] <= 1e-4 + 1e-4 * np.abs(want[~undetermined])).all(), k
            assert (diff[undetermined] <= 2 * LR + 1e-4).all(), k
        js = ref["serve"]
        np.testing.assert_array_equal(got["serve"]["match_indices"],
                                      np.asarray(js.match_indices)[d:d + 1])
        np.testing.assert_array_equal(got["serve"]["valid"],
                                      np.asarray(js.valid)[d:d + 1].astype(np.float32))
        np.testing.assert_allclose(got["serve"]["match_scores"],
                                   np.asarray(js.match_scores)[d:d + 1], atol=1e-5)
        assert got["serve"]["match_indices"].max() < 5


class _Group:
    def __init__(self, backend: str):
        self.backend = backend


@pytest.mark.parametrize("shape,backends,want", [
    ((1, 1), {}, True),  # one rank: nothing to capture across
    ((2, 1), {"data": "nccl"}, True),
    ((1, 4), {"model": "nccl"}, True),
    ((2, 2), {"data": "nccl", "model": "nccl"}, True),
    ((2, 1), {"data": "gloo"}, False),
    ((2, 2), {"data": "nccl", "model": "gloo"}, False),
    ((2, 2), {}, False),  # layout only: no process group
])
def test_capturable_decision(monkeypatch, shape, backends, want):
    """A mesh's steps are captured at world size 1, or where every group
    of more than one rank is NCCL's; gloo's and a layout-only mesh's stay
    eager."""
    monkeypatch.setattr(M.dist, "get_backend", lambda g: g.backend)
    dp, mp = shape
    mesh = M.build_mesh(MeshConfig(data_parallel=dp, model_parallel=mp), world_size=dp * mp,
                        rank=0, device="cpu")
    groups = {axis: _Group(b) for axis, b in backends.items()}
    mesh = M.Mesh(mesh.shape, 0, mesh.device, {"data": None, "model": None} | groups)
    assert M.capturable(mesh) is want
    assert M.capturable(None) is True


def test_multichip_refuses_a_layout_without_its_cards(monkeypatch):
    """No card here: the run, the spawned dry run and any layout refuse to
    start, and never fall back to gloo or the CPU; a machine with two cards
    refuses a four-rank layout too."""
    with pytest.raises(RuntimeError, match="needs 4 CUDA cards"):
        multichip.main([])
    with pytest.raises(RuntimeError, match="needs 4 CUDA cards"):
        multichip.dryrun_multichip(4)
    multichip.require_cards(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="has 2"):
        multichip.require_cards(4)
    multichip.require_cards(2)


def test_command_line_over_four_ranks_equals_one_process(tmp_path, monkeypatch):
    """``train`` and ``evaluate`` through ``torchrun`` on four gloo ranks
    (data 4), as the full-width run starts them on four cards, at 32 px:
    the training runs at data 4, its checkpoint loads in one process, and
    the four ranks' evaluation equals one process's."""
    from facerec_torch.data.synthetic import write_synthetic_imagefolder

    monkeypatch.setattr(multichip, "CLI_IMAGE", 32)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ds = write_synthetic_imagefolder(tmp_path / "ds", num_classes=16, per_class=12, size=32,
                                     seed=0)
    out = multichip.cli_train_and_evaluate(tmp_path / "work", ds, device="cpu")
    assert out["mesh"] == "(mesh {'data': 4, 'model': 1})"
    assert out["epochs_trained"] == multichip.CLI_EPOCHS and out["checkpoint_tensors"] > 100
    assert out["four_ranks"] == pytest.approx(out["one_process"], abs=1e-3)
    assert out["four_ranks"]["accuracy"] == out["one_process"]["accuracy"]
    assert out["same_confusion"] and out["same_per_class"]
