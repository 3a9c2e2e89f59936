"""Train traffic: the train step ``train_model`` runs
(``make_train_step``, a replayed CUDA graph on the card), fed by
``prefetch_to_device`` from a pool of host batches, as many steps as the
window holds. The model is the configuration's embedder, trained as its
kind's module says (``embedders``); the optimizer is the configuration's
``train.optimizer``.

Set-up draws the pool from the seed (f32 images [B, S, S, 3] as the
datasets yield them, labels over the configuration's classes), makes the
model's weights on the card from the seed, builds the port's train state
and step on them, and drives that same state through the first
``check_steps`` steps of the window's own call and feed, on distinct
batches: their losses, the first gradient as the optimizer holds it
(Adam's first moment over 1 - beta1, SGD's momentum trace) and the
parameters after the last of them are kept for the comparison. The
window then runs step after step on the same state; its rate counts every
image of every step, the device synchronised at the close.

With ``trace``, a span is recorded around each ``next()`` on the feed, and
after the window a few steps run under the profiler.

A traffic of ``ranks`` > 1 is the ``(ranks, 1)`` data-parallel mesh: the
run spawns one process a card, each builds the same state, shards it
(``shard_params``) and feeds ``prefetch_to_device`` the global batch, of
which it keeps its slice; the ranks agree every ``STOP_EVERY`` steps
whether the window has closed. Rank 0's numbers, the ranks' traces and
the modules each rank has loaded of JAX or the JAX package come back to
the spawning process, which prints the result, or none where a rank has
loaded one.

Once the window has closed and the peak memory has been read, the
program's state is freed and the plain reference follows the first steps
from the same weights and batches (``judge_train``)."""

from __future__ import annotations

import gc
import os
import socket
import time

import numpy as np
import torch

from perfbench import embedders, harness, trace, weights
from perfbench.judge_train import judge
from perfbench.reference import optim
from perfbench.reference.precision import no_tf32

STOP_EVERY = 16  # steps between the ranks' checks of the window's close
RANK_TIMEOUT_S = 900


def host_pool(traffic: dict, config: dict, seed: int) -> list[dict[str, np.ndarray]]:
    rng = np.random.default_rng(weights.sub_seed(seed, "train_data"))
    b, s, c = traffic["batch"] * traffic.get("ranks", 1), traffic["image"], \
        config["train"]["num_classes"]
    return [{"image": rng.standard_normal((b, s, s, 3), dtype=np.float32),
             "label": rng.integers(0, c, (b,)).astype(np.int32)}
            for _ in range(traffic["pool_batches"])]


def feed(pool):
    """The pool's batches in turn, for ever."""
    i = 0
    while True:
        yield pool[i % len(pool)]
        i += 1


def kind(config: dict):
    """The module of the configuration's embedder kind, with what training
    needs of it; the optimizer checked. An unknown or untrained kind, or an
    unknown optimizer, fails here, at set-up, naming it."""
    optim.check(config["train"]["optimizer"])
    return embedders.get(config["embedder"]["kind"], train=True)


def model_state(arch, t: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The weights (f32, the parameters' type) of the model that ``arch``,
    the kind's module, trains on the ``train`` section ``t``, from the seed."""
    return weights.make_state(arch.train_shapes(t), seed, device, torch.float32)


def flops_per_image(arch, t: dict, traffic: dict) -> int:
    """The benchmark's FLOPs of one training image: 3 x the forward count
    (its kind's ``train_macs``), a multiply-add 2."""
    return 3 * 2 * arch.train_macs(t, traffic["image"])


def build(cell: dict, arch, seed: int, device, mesh=None):
    """(train state, train step) of the port, on the benchmark's weights;
    with ``mesh``, sharded over it."""
    from facerec_torch.config import OptimizerConfig

    t = cell["config"]["train"]
    o = t["optimizer"]
    keys = {k: o[k] for k in optim.check(o).KEYS if k != "clip_norm"}
    opt = OptimizerConfig(name=o["name"], grad_clip_norm=o["clip_norm"], **keys)
    state, step = arch.train_program(t, opt, cell["traffic"]["batch"], dropout_seed(seed), device,
                                     mesh)
    with torch.no_grad():
        state.model.load_state_dict(model_state(arch, t, seed, device))
    if mesh is not None:
        from facerec_torch.parallel.mesh import shard_params

        shard_params(state.model, mesh)
    return state, step


def dropout_seed(seed: int) -> int:
    return weights.sub_seed(seed, "train_model") % (1 << 31)


def _params(state) -> dict[str, torch.Tensor]:
    """The parameters and the BatchNorm running statistics, f32 copies."""
    out = {n: p.detach().float().clone() for n, p in state.model.named_parameters()}
    out.update({n: b.detach().float().clone() for n, b in state.model.named_buffers()
                if n.rsplit(".", 1)[-1] in ("running_mean", "running_var")})
    return out


def _window(step, state, next_batch, seconds: float, mesh) -> tuple[int, float]:
    """(steps, seconds) of the window: steps until ``seconds`` have passed;
    with a mesh, until any rank finds them passed at a check every
    ``STOP_EVERY`` steps. The device is synchronised at the close."""
    import torch.distributed as dist

    on_card = state.device.type == "cuda"
    if mesh is not None:
        dist.barrier()
    n = 0
    w0 = time.perf_counter()
    deadline = w0 + seconds
    flag = torch.zeros((), device=state.device)
    while True:
        if mesh is None:
            if time.perf_counter() >= deadline:
                break
        elif n % STOP_EVERY == 0 and n:
            flag.fill_(float(time.perf_counter() >= deadline))
            dist.all_reduce(flag, group=mesh.group(mesh.data_axis))
            if float(flag) > 0:
                break
        step(state, next_batch())
        n += 1
    if on_card:
        torch.cuda.synchronize()
    return n, time.perf_counter() - w0


def run(cell: dict, seed: int, seconds: float, traced: bool, t0: float, device,
        mesh=None) -> dict:
    from facerec_torch.data.pipeline import prefetch_to_device

    traffic, config = cell["traffic"], cell["config"]
    if mesh is not None:
        device = mesh.device
    on_card = torch.device(device).type == "cuda"
    no_tf32()  # as train_model sets it: the margin head's cosine product is full f32
    arch = kind(config)  # an unknown kind or optimizer fails here
    image_flops = flops_per_image(arch, config["train"], traffic)
    pool = host_pool(traffic, config, seed)
    state, step = build(cell, arch, seed, device, mesh)
    spans = trace.Spans()
    it = prefetch_to_device(feed(pool), device=device, mesh=mesh)
    next_batch = spans.wrap("train.input_wait", it.__next__) if traced else it.__next__
    # the first steps, through the window's own call and feed
    names = [n for n, _ in state.model.named_parameters()]
    p0 = _params(state)
    first = {"losses": [], "grad": None}
    metrics = []
    opt = config["train"]["optimizer"]
    for k in range(traffic["check_steps"]):
        metrics.append(step(state, next_batch()))
        if k == 0:
            unclip = torch.clamp(metrics[0]["grad_norm"].float() / opt["clip_norm"], min=1.0)
            grads = optim.check(opt).first_gradient(state.opt_state.slots, opt)
            first["grad"] = {n: g * unclip for n, g in zip(names, grads)}
    first["params"] = _params(state)
    first["losses"] = [float(m["loss_sum"] / torch.clamp(m["count"], min=1.0)) for m in metrics]
    first["grad_norms"] = [float(m["grad_norm"]) for m in metrics]
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    spans.spans.clear()
    n, window_s = _window(step, state, next_batch, seconds, mesh)
    images = n * traffic["batch"] * traffic.get("ranks", 1)
    out = {"attempted": n, "failed": 0, "setup_s": setup_s,
           "train_images_per_s": images / window_s}
    ctx = {"spans": spans, "window": {"steps": n, "seconds": window_s, "images": images},
           "config": config, "traffic": traffic, "chips": traffic.get("ranks", 1),
           "flops_per_image": image_flops}
    if traced and on_card:
        align = None
        if mesh is not None:
            import torch.distributed as dist

            align = dist.barrier
        ctx["profile"] = trace.profile(lambda j: step(state, it.__next__()),
                                       traffic["profiled_steps"], align)
    out["ctx"] = ctx
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if on_card else 0
    it.close()
    del state, step, it
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
        if mesh.rank != 0:
            return out
    c0 = time.perf_counter()
    out["numbers"] = judge(arch, config, traffic, seed, device, pool, p0, first)
    out["check_s"] = time.perf_counter() - c0
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, cell: dict, seeds: list[int],
               seconds: float, traced: bool, t0: float, backend: str, queue) -> None:
    """One rank: join the group, run each seed in turn, hand rank 0's
    results and every rank's trace to the spawning process."""
    import torch.distributed as dist

    from facerec_torch.config import MeshConfig
    from facerec_torch.parallel.mesh import build_mesh, initialize_distributed

    if backend == "gloo":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world // 2))
    initialize_distributed(f"localhost:{port}", world, rank, backend=backend)
    try:
        mesh = build_mesh(MeshConfig(data_parallel=world),
                          device="cpu" if backend == "gloo" else None)
        for seed in seeds:
            out = run(cell, seed, seconds, traced, t0, None, mesh)
            if rank:
                out = {"ctx": {"profile": out["ctx"].get("profile")},
                       "memory_peak_bytes": out["memory_peak_bytes"]}
            out["forbidden"] = harness.forbidden_modules()  # this rank ran the window
            queue.put((rank, seed, out))
            t0 = time.perf_counter()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(cell: dict, seeds: list[int], seconds: float, traced: bool, t0: float,
          backend: str = "nccl", target=None) -> dict[int, dict]:
    """For each seed, rank 0's result with the ranks merged: the peak memory
    of the fullest card, the modules of JAX or the JAX package that any rank
    loaded, the busy time averaged over the cards, the slowest
    rank's trace (the most device time outside NCCL's kernels) for the
    per-layer numbers. ``target`` stands in for
    ``_rank_main`` (tests plant faults through it)."""
    world = cell["traffic"]["ranks"]
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target or _rank_main, args=(r, world, port, cell, seeds, seconds, traced,
                                                  t0, backend, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict[tuple[int, int], dict] = {}
    start = time.perf_counter()
    try:
        while len(got) < world * len(seeds):
            if any(p.exitcode not in (None, 0) for p in procs):
                raise RuntimeError(f"a rank failed: exit codes {[p.exitcode for p in procs]}")
            if time.perf_counter() - start > RANK_TIMEOUT_S * len(seeds):
                raise RuntimeError("the ranks did not finish in time")
            try:
                r, seed, out = queue.get(timeout=5.0)
            except Exception:  # nothing yet: look at the ranks again
                continue
            got[(r, seed)] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    merged = {}
    for seed in seeds:
        outs = [got[(r, seed)] for r in range(world)]
        out = outs[0]
        out["memory_peak_bytes"] = max(o["memory_peak_bytes"] for o in outs)
        out["forbidden"] = sorted({m for o in outs for m in o["forbidden"]})
        profs = [o["ctx"].get("profile") for o in outs]
        if all(p is not None for p in profs):
            # NCCL's kernels spin while their rank waits for the others, so the
            # slowest rank is the one with the most device time outside them
            slow = max(profs, key=lambda p: p["busy_s"] - trace.device_seconds(p, "nccl")[0])
            out["ctx"]["profile"] = dict(slow, busy_s=sum(p["busy_s"] for p in profs) / world,
                                         slowest_busy_s=slow["busy_s"])
        merged[seed] = out
    return merged


def main(cell: dict, seed: int, seconds: float, traced: bool, t0: float) -> int:
    if cell["traffic"].get("ranks", 1) > 1:
        kind(cell["config"])  # before any rank starts
        out = spawn(cell, [seed], seconds, traced, t0)[seed]
    else:
        out = run(cell, seed, seconds, traced, t0, "cuda")
    return harness.emit(cell, out, traced)
