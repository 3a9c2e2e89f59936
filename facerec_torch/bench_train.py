"""Train-step throughput on one card (counterpart of
``tools/bench_train.py``).

    python -m facerec_torch.bench_train [--device cuda|cpu]

Env, with the JAX tool's names and defaults: ``BENCH_TRAIN_MODEL``
(``arcface``|``siamese``|``baseline``, default ``arcface``) and
``BENCH_TRAIN_BATCH`` (256). The model is the reference's scale (the
type's full-width model, 18 classes, 160 px, the ``TrainConfig`` defaults:
bf16 compute, f32 parameters), its state from ``create_train_state`` at
seed 0. A pool of 8 distinct device-resident batches is drawn from
``default_rng(0)`` as the JAX tool's ``make_batches`` draws it.

The train step is the one ``train_model`` runs: on the card, the replay
of its CUDA graph (``train/steps.py``), so host dispatch does not enter the
number, as the JAX tool scans its jitted step for the same reason. It is
timed with CUDA events over the pool after warm-up; ``compile_s`` is the
seconds of the capture and the warm-up. The eval step is timed as
``evaluate_model`` runs it (eager, no gradients). The last line of stdout
is the JAX tool's JSON line; a ``#`` line on stderr gives the card's name
and power limit, the captured and the eager step's ms from the same call,
timed in turns (captured, eager, eager, captured), and for each the device
ms per step and the busy share over 3 steps (torch.profiler). On the CPU
(``--device cpu``) the steps are timed with the host clock and the busy
share is not measured.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

IMAGE = 160
NUM_CLASSES = 18
POOL = 8
WARMUP, STEPS = 3, 24  # warm-up replays after the capture; timed steps
PROFILED_STEPS = 3


def make_batches(model_type: str, batch: int, size: int, n_pool: int,
                 device: torch.device) -> list[dict[str, torch.Tensor]]:
    """``n_pool`` distinct batches on ``device``, drawn from
    ``default_rng(0)`` in the JAX tool's order."""
    rng = np.random.default_rng(0)
    pool = []
    for _ in range(n_pool):
        if model_type == "siamese":
            b = {
                "image_a": rng.normal(0, 1, (batch, size, size, 3)).astype(np.float32),
                "image_b": rng.normal(0, 1, (batch, size, size, 3)).astype(np.float32),
                "pair_label": rng.integers(0, 2, (batch,)).astype(np.int32),
            }
        else:
            b = {
                "image": rng.normal(0, 1, (batch, size, size, 3)).astype(np.float32),
                "label": rng.integers(0, NUM_CLASSES, (batch,)).astype(np.int32),
            }
        pool.append({k: torch.from_numpy(v).to(device) for k, v in b.items()})
    return pool


def _timed_ms(fn, n: int, on_card: bool) -> float:
    """ms per call of ``fn`` over ``n`` calls: CUDA events on the card, the
    host clock on the CPU."""
    if not on_card:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        return (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _profiled(fn, n: int) -> dict[str, float]:
    """Device ms per call (the sum of the card's kernel and copy time,
    torch.profiler) and the busy share of the wall time over ``n`` calls.
    The profiler's own host cost lengthens the wall time, so the share is a
    lower bound."""
    from torch.profiler import ProfilerActivity, profile

    from facerec_torch.utils import profiling

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(e.self_device_time_total for e in profiling.device_ops(prof))
    return {"device_ms": busy_us / n / 1e3, "busy_share": busy_us / wall_us}


def run(model_type: str = "arcface", batch: int = 256, image: int = IMAGE, steps: int = STEPS,
        device: str | torch.device | None = None) -> tuple[dict, dict]:
    """The benchmark; returns (the JAX tool's JSON line, the ``#`` line's
    details)."""
    from facerec_torch import resolve_device
    from facerec_torch.bench import card_label
    from facerec_torch.config import TrainConfig
    from facerec_torch.models import get_model
    from facerec_torch.train.state import create_train_state
    from facerec_torch.train.steps import make_eval_step, make_train_step

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:  # as train_model sets them: the ArcFace cosine product needs full f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = TrainConfig(model_type=model_type, batch_size=batch, num_classes=NUM_CLASSES, seed=0)
    pool = make_batches(model_type, batch, image, POOL, dev)
    state = create_train_state(get_model(model_type, num_classes=NUM_CLASSES), cfg, model_type,
                               dev)
    train_step = make_train_step(model_type, cfg.compute_dtype)
    eval_step = make_eval_step(model_type, cfg.compute_dtype)

    def captured(i):
        train_step(state, pool[i % POOL])

    def eager(i):
        train_step.eager(state, pool[i % POOL])

    t0 = time.perf_counter()
    for i in range(WARMUP):  # the first call captures
        captured(i)
    if on_card:
        torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    for i in range(WARMUP):
        eager(i)
    turns = {"captured": [], "eager": []}
    for kind in ("captured", "eager", "eager", "captured"):
        turns[kind].append(_timed_ms(captured if kind == "captured" else eager, steps, on_card))
    step_ms = sum(turns["captured"]) / 2

    def evaluate(i):
        eval_step(state, pool[i % POOL])

    evaluate(0)
    eval_ms = _timed_ms(evaluate, steps, on_card)
    out = {
        "model": model_type,
        "batch": batch,
        "image": image,
        "train_step_ms": round(step_ms, 2),
        "train_imgs_per_sec": round(batch / (step_ms * 1e-3), 1),
        "eval_step_ms": round(eval_ms, 2),
        "eval_imgs_per_sec": round(batch / (eval_ms * 1e-3), 1),
        "backend": dev.type,
        "devices": torch.cuda.device_count() if on_card else 1,
        "compile_s": round(compile_s, 1),
    }
    note = {"train_step_ms_turns": turns["captured"], "eager_step_ms_turns": turns["eager"],
            "eager_step_ms": sum(turns["eager"]) / 2, "timing": "cuda_events" if on_card
            else "host_clock", "card": card_label(dev)}
    for kind, fn in (("captured", captured), ("eager", eager)):
        prof = _profiled(fn, PROFILED_STEPS) if on_card else {"device_ms": None,
                                                             "busy_share": None}
        note[f"{kind}_device_ms_per_step"] = prof["device_ms"]
        note[f"{kind}_busy_share"] = prof["busy_share"]
    return out, note


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m facerec_torch.bench_train",
                                description="train-step throughput (tools/bench_train.py's)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    out, note = run(model_type=os.environ.get("BENCH_TRAIN_MODEL", "arcface"),
                    batch=int(os.environ.get("BENCH_TRAIN_BATCH", 256)), device=args.device)
    print(json.dumps(out), flush=True)
    print("# " + json.dumps(note), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
