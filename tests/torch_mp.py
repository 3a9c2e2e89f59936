"""Spawn harness and rank bodies for the port's multi-rank tests
(``tests/test_torch_parallel.py``).

``run_ranks(fn, world, tmp_path, *args)`` starts ``world`` processes with
``spawn``; each calls ``torch.set_num_threads(1)``, joins one gloo process
group through a ``file://`` rendezvous under ``tmp_path`` (so parallel test
workers never race for a port) and returns ``fn(rank, world, *args)``. The
parent waits at most ``timeout`` seconds, kills every rank still running
when that passes or when one rank has failed, and fails the test: a hung
rendezvous never runs the suite into its time limit.

The rank bodies import torch and the port only (never JAX), so a rank
starts in a few seconds.
"""

from __future__ import annotations

import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

TIMEOUT_S = 120


def run_ranks(fn, world: int, tmp_path: Path, *args, timeout: float = TIMEOUT_S) -> list:
    """``[fn(rank, world, *args) for rank in range(world)]``, each in its own
    process of one gloo group."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = Path(tmp_path) / f"ranks_{time.monotonic_ns()}"
    out.mkdir(parents=True)
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, str(out), args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    failed = None
    while time.monotonic() < deadline:
        done = [p.exitcode is not None for p in procs]
        if all(done):
            break
        failed = next((r for r, p in enumerate(procs) if p.exitcode not in (None, 0)), None)
        if failed is not None:
            break
        time.sleep(0.05)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    for p in procs:
        p.join(10)
    found = {r: pickle.loads((out / f"rank{r}.pkl").read_bytes())
             for r in range(world) if (out / f"rank{r}.pkl").exists()}
    for r, (ok, payload) in found.items():
        if not ok:
            pytest.fail(f"rank {r} of {world} raised:\n{payload}")
    for r, p in enumerate(procs):
        if r not in found:
            why = "still running" if p in alive else f"exit code {p.exitcode}"
            pytest.fail(f"rank {r} of {world} left no result ({why}; limit {timeout:.0f} s)")
    return [found[r][1] for r in range(world)]


def _rank_main(fn, rank: int, world: int, out: str, args) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/rendezvous", world_size=world,
                            rank=rank)
    try:
        result = (True, fn(rank, world, *args))
    except BaseException:  # reported by the parent, which fails the test
        result = (False, traceback.format_exc())
    Path(out, f"rank{rank}.pkl.tmp").write_bytes(pickle.dumps(result))
    Path(out, f"rank{rank}.pkl.tmp").rename(Path(out, f"rank{rank}.pkl"))
    if not result[0]:
        raise SystemExit(1)
    dist.destroy_process_group()


def _mesh(data: int, model: int):
    from facerec_torch.config import MeshConfig
    from facerec_torch.parallel.mesh import build_mesh

    return build_mesh(MeshConfig(data_parallel=data, model_parallel=model), device="cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


# -- rank bodies ---------------------------------------------------------------------------


def collectives(rank: int, world: int) -> dict:
    """Every collective on a (2, 2) mesh, and the top-k merge of shards
    with ties and empty shards over the four ranks."""
    from facerec_torch.parallel import collectives as C

    mesh = _mesh(2, 2)
    d, m = mesh.coords
    x = torch.tensor([float(rank + 1), 10.0 * (rank + 1)])
    xg = x.clone().requires_grad_(True)
    summed = C.psum(xg, mesh, "data")
    (summed * torch.tensor([1.0, 2.0])).sum().backward()
    out = {
        "coords": mesh.coords, "axis_index": (C.axis_index(mesh, "data"),
                                               C.axis_index(mesh, "model")),
        "psum_data": _np(summed), "psum_grad": _np(xg.grad),
        "pmean_model": _np(C.pmean(x, mesh, "model")),
        "gather_tiled": _np(C.all_gather(x, mesh, "model")),
        "gather_untiled": _np(C.all_gather(x[None], mesh, "data", dim=1, tiled=False)),
        "ring": _np(C.ppermute_ring(x, mesh, "model", shift=1)),
        "ring_back": _np(C.ppermute_ring(x, mesh, "data", shift=-1)),
        "scatter": _np(C.reduce_scatter(torch.arange(4.0) * (rank + 1), mesh, "data")),
        "object": C.broadcast_object({"rank": rank}, mesh),
    }
    # the merge over all four ranks as one model axis
    flat = _mesh(1, 4)
    vals, idx = merge_shards(rank)
    gv, gi, gs = C.global_topk_merge(torch.from_numpy(vals), torch.from_numpy(idx), 3, flat)
    out["merge"] = (_np(gv), _np(gi), _np(gs))
    return out


def merge_shards(rank: int) -> tuple[np.ndarray, np.ndarray]:
    """Shard ``rank``'s top-3 of 2 queries: shard 0 full, shard 1 ties with
    shard 0 and has one masked slot, shards 2 and 3 empty (masked -1e30 in
    every slot, indices 0, 1, 2)."""
    masked = np.float32(-1e30)
    table = {
        0: [[0.9, 0.5, 0.5], [0.3, 0.2, 0.1]],
        1: [[0.5, 0.4, masked], [0.3, masked, masked]],
        2: [[masked] * 3, [masked] * 3],
        3: [[masked] * 3, [masked] * 3],
    }
    vals = np.asarray(table[rank], np.float32)
    idx = np.tile(np.arange(3, dtype=np.int32), (2, 1))
    return vals, idx


def dp_step(rank: int, world: int, state_dict: dict, batch: dict, opt: dict,
            model_type: str, num_classes: int, steps: int = 1, width: int = 8) -> dict:
    """``steps`` train steps of ``model_type`` over a ``(world, 1)`` mesh
    (``world`` 1: no mesh), on this rank's slice of ``batch``."""
    from facerec_torch.config import OptimizerConfig
    from facerec_torch.train.state import OptaxChain, TrainState
    from facerec_torch.train.steps import make_train_step

    mesh = _mesh(world, 1) if world > 1 else None
    net = build_net(model_type, num_classes, width)
    net.load_state_dict(state_dict)
    state = TrainState(model=net, opt_state=OptaxChain(net.named_parameters(),
                                                       OptimizerConfig(**opt), model_type),
                       seed=3)
    per = len(batch["mask"]) // world
    local = {k: torch.from_numpy(np.ascontiguousarray(v[rank * per:(rank + 1) * per]))
             for k, v in batch.items()}
    step = make_train_step(model_type, "float32", mesh)
    metrics = [{k: float(v) for k, v in step(state, local).items()} for _ in range(steps)]
    return {"metrics": metrics, "state": {k: _np(v) for k, v in net.state_dict().items()}}


def build_net(model_type: str, num_classes: int, width: int = 8):
    """The baseline net with its dropout off, or a narrow ArcFace net with
    its dropout on."""
    from facerec_torch.models.arcface import ArcFaceNet
    from facerec_torch.models.baseline import BaselineNet

    if model_type == "baseline":
        return BaselineNet(num_classes=num_classes, dropout_rate=0.0)
    return ArcFaceNet(num_classes=num_classes, width=width, dropout_rate=0.2)


class FloatEmbedder(torch.nn.Module):
    """A baseline net whose ``embed`` takes the serve step's bf16 crops as
    f32 (Flax promotes bf16 input and f32 parameters to f32)."""

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self.net = net

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        return self.net.embed(x.float())


def serve(rank: int, world: int, data: int, model: int, capacity: int, det_params: dict,
          embed_state: dict, gallery: np.ndarray, frames: np.ndarray, remove: str) -> dict:
    """The sharded serve step at tests/test_parallel.py's configuration on a
    ``(data, model)`` mesh: this rank's results, enrolled row by row, then
    after ``remove``; also the shard's count and the gallery it saves."""
    from facerec_torch.config import ServeConfig
    from facerec_torch.detect.mtcnn import MTCNN
    from facerec_torch.models.baseline import BaselineNet
    from facerec_torch.serve.pipeline import FacePipeline

    mesh = _mesh(data, model)
    cfg = ServeConfig(max_faces=4, gallery_capacity=capacity, top_k=3, embed_size=32,
                      detection_threshold=0.0, recognition_threshold=10.0)
    det = MTCNN((96, 96), min_face_size=24, max_faces=4, k_pnet=16, k_rnet=8, device="cpu")
    det.load_jax_params(det_params)
    net = BaselineNet(num_classes=4)
    net.load_state_dict(embed_state)
    pipe = FacePipeline(cfg, (96, 96), det, FloatEmbedder(net.eval()), embed_dim=512,
                        mesh=mesh)
    for i, e in enumerate(gallery):
        pipe.gallery.add(f"p{i}", e)
    before = {k: _np(v) for k, v in pipe.process(frames)._asdict().items()}
    local_count = pipe.gallery.local_count
    pipe.gallery.remove(remove)
    after = {k: _np(v) for k, v in pipe.process(frames)._asdict().items()}
    return {"coords": mesh.coords, "before": before, "after": after, "local_count": local_count,
            "rows": pipe.gallery.embeddings.float().numpy(), "lo": pipe.gallery.lo}


def gallery_ops(rank: int, world: int, capacity: int, rows: np.ndarray, out_dir: str) -> dict:
    """A gallery sharded over a ``(1, world)`` mesh through every mutation:
    add, add_many, add_many_device, remove in each shard and across a
    boundary, rename; then saved (rank 0 writes) and loaded back sharded."""
    from facerec_torch.serve.gallery import GalleryStore

    mesh = _mesh(1, world)
    g = GalleryStore(capacity=capacity, dim=rows.shape[1], mesh=mesh)
    n = len(rows)
    g.add("a0", rows[0])
    g.add_many([f"a{i}" for i in range(1, n // 2)], rows[1:n // 2])
    g.add_many_device([f"a{i}" for i in range(n // 2, n)], torch.from_numpy(rows[n // 2:]))
    for name in ("a1", f"a{capacity // world}", f"a{n - 1}", "a0"):
        g.remove(name)
    g.rename("a2", "renamed")
    g.save(out_dir)
    loaded = GalleryStore.load(out_dir, capacity=capacity, mesh=mesh)
    return {"names": list(g.names), "rows": g.embeddings.numpy().copy(),
            "count": int(g.count_device), "local_count": g.local_count,
            "local_count_device": int(g.local_count_device()),
            "loaded_rows": loaded.embeddings.numpy().copy(), "loaded_names": list(loaded.names)}


def sync_batchnorm(rank: int, world: int, x: np.ndarray) -> dict:
    """Train-mode BatchNorm inside a data-parallel region on this rank's
    rows of ``x``: the output rows, the gradient of a weighted sum with
    respect to the input rows and the parameters, and the running
    statistics."""
    from facerec_torch.models.resnet import BatchNorm
    from facerec_torch.parallel.mesh import data_parallel

    mesh = _mesh(world, 1) if world > 1 else None
    bn = BatchNorm(x.shape[1], eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[1]))
    per = len(x) // world
    xl = torch.from_numpy(x[rank * per:(rank + 1) * per]).requires_grad_(True)
    with data_parallel(mesh):
        y = bn(xl)
    weights = torch.arange(x.size, dtype=torch.float32).reshape(x.shape).sin()
    (y * weights[rank * per:(rank + 1) * per]).sum().backward()
    grads = [bn.weight.grad, bn.bias.grad]
    if mesh is not None:  # the parameters' gradients of the global sum
        from facerec_torch.parallel.collectives import psum

        grads = [psum(g, mesh) for g in grads]
    return {"y": _np(y), "dx": _np(xl.grad), "dw": _np(grads[0]), "db": _np(grads[1]),
            "mean": _np(bn.running_mean), "var": _np(bn.running_var)}


def train(rank: int, world: int, root: str, ckroot: str, cfg_dict: dict) -> dict:
    """``train_model`` over a ``(world, 1)`` mesh; the history, the test
    metrics and the final parameters."""
    from facerec_torch.config import TrainConfig
    from facerec_torch.train.engine import train_model

    cfg = TrainConfig.from_dict(cfg_dict)
    out = train_model(cfg, root, checkpoints_root=ckroot, model_name="dp", device="cpu")
    return {"history": out["history"], "test_acc": out["test_acc"],
            "test_loss": out["test_loss"], "best_val_acc": out["best_val_acc"],
            "state": {k: _np(v) for k, v in out["model"].state_dict().items()}}


def evaluate(rank: int, world: int, root: str, ckroot: str, outroot: str,
             model_type: str) -> dict:
    """``evaluate_model`` over every rank (the default mesh)."""
    from facerec_torch.config import EvalConfig
    from facerec_torch.eval.engine import evaluate_model

    res = evaluate_model(EvalConfig(model_type=model_type, model_name="m", image_size=32,
                                    batch_size=6, compute_dtype="float32"),
                         root, checkpoints_root=ckroot, outputs_root=outroot,
                         return_predictions=True, device="cpu")
    return {k: v for k, v in res.items() if k not in ("avg_inference_time_ms",
                                                     "throughput_imgs_per_sec",
                                                     "throughput_pairs_per_sec")}


def dryrun(rank: int, world: int, model_parallel: int, init: dict) -> dict:
    """``multichip.dryrun_multichip`` as this rank of a (world / mp, mp)
    gloo mesh, from ``init``'s weights with the ArcFace dropout off; also
    whether the mesh's steps would be captured on a card."""
    from facerec_torch import multichip
    from facerec_torch.parallel.mesh import capturable

    out = multichip.dryrun_multichip(world, model_parallel=model_parallel, device="cpu",
                                     init=init, dropout_rate=0.0)
    out["capturable"] = capturable(_mesh(world // model_parallel, model_parallel))
    return out
