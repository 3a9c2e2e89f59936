"""Readings for the limits of a cell's comparison: the program's, over
many seeds, and the control's, the plain reference put in the program's
place and computed in fp8 (``reference.precision``), judged by the same
comparison. In a train cell also a planted fault, the reference put in the
program's place with its loss the mean over half of each batch
(``--fault half_batch``) or, on several ranks, rank 0's step alone on its
slice (``--fault no_exchange``). The control and the faults run the
reference only, so one card reads them at any cell's size.

    python3 -m perfbench.control --workload <name> --seeds 1,2,3 [--seconds 3]
        [--control-seeds 1,2,3] [--out readings.jsonl]

One process reads every seed, so the build and the card's start-up are
paid once. Each line printed (and appended to ``--out``) is one JSON
object: {"seed", "side": "program" or "control", "numbers": {...}}; a
program line also has the run's end-to-end values."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from perfbench import embedders, harness, weights
from perfbench.drivers import serve
from perfbench.judge_serve import merge
from perfbench.judge_train import FAULTS
from perfbench.reference import serve as ref_serve
from perfbench.reference.precision import Precision, no_tf32


def control_numbers(cell: dict, seed: int, device, precision: str = "fp8") -> dict:
    """The comparison's numbers for the reference in ``precision`` put in
    the program's place, on as many requests as a run compares."""
    config, traffic = cell["config"], cell["traffic"]
    emb_c = config["embedder"]
    pool = serve.frame_pool(traffic, seed)
    trees = serve.detector_trees(config)
    state = weights.make_state(embedders.get(emb_c["kind"]).shapes(emb_c), seed, device,
                               getattr(torch, config["dtype"]))
    judge = serve.reference_judge(cell, seed, device, state, trees)
    low = Precision(precision)
    readings = []
    with torch.no_grad():
        for i in range(traffic["check_requests"]):
            frames = torch.from_numpy(serve.request_frames(pool, i)).to(device).float()
            ans = ref_serve.serve(low, judge.det_weights, judge.spec, judge.embed_fn, judge.size,
                                  judge.gallery, serve.row_name, frames)
            readings.append(judge.judge(ans, frames))
    return merge(readings)


def train_control_numbers(cell: dict, seed: int, device, precision: str = "fp8",
                          fault: str = "") -> dict:
    """The train comparison's numbers for the reference put in the
    program's place: in ``precision``, or in f32 with ``fault`` planted."""
    from perfbench import judge_train
    from perfbench.drivers import train

    no_tf32()
    pool = train.host_pool(cell["traffic"], cell["config"], seed)
    args = (train.kind(cell["config"]), cell["config"], cell["traffic"], seed, device, pool)
    p0, ref = judge_train.follow(*args)
    if fault:
        _, side = judge_train.follow(*args, fault=fault)
    else:
        _, side = judge_train.follow(*args, precision=precision)
    return judge_train.compare(p0, side, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--precision", default="fp8")
    p.add_argument("--fault", default="", help="train cells: half_batch or no_exchange")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    cell = harness.cell(args.workload)
    device = "cuda"
    if args.fault and args.fault not in FAULTS:
        raise SystemExit(f"unknown fault {args.fault!r}")

    def emit(line):
        s = json.dumps(line)
        print(s, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(s + "\n")

    drv = harness.driver(cell["traffic"])
    seeds = [int(x) for x in args.seeds.split(",") if x]

    def program_line(s, out):
        emit({"workload": args.workload, "seed": s, "side": "program",
              "numbers": out["numbers"], "attempted": out["attempted"],
              "setup_s": out["setup_s"], "memory_peak_bytes": out["memory_peak_bytes"],
              **{m["name"]: out[m["name"]] for m in cell["end_to_end"]}})

    if seeds and cell["traffic"].get("ranks", 1) > 1:
        for s, out in drv.spawn(cell, seeds, args.seconds, False, time.perf_counter()).items():
            program_line(s, out)
    for s in seeds if cell["traffic"].get("ranks", 1) == 1 else []:
        program_line(s, drv.run(cell, s, args.seconds, False, time.perf_counter(), device))
        torch.cuda.empty_cache()
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        if cell["traffic"]["driver"] == "train":
            numbers = train_control_numbers(cell, s, device, args.precision, args.fault)
        else:
            numbers = control_numbers(cell, s, device, args.precision)
        emit({"workload": args.workload, "seed": s, "side": args.fault or "control",
              "precision": args.precision, "numbers": numbers})
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
