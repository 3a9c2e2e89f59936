"""What the harness finds by name, and the result line.

A cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration and
a traffic mix. Each is a file of its own: ``configs/<config>.json`` (the
configuration's file, as ``BENCHMARK.json`` names it) and
``traffic/<traffic>.json``, whose ``driver`` names the module under
``drivers/`` that runs it. The limits of the cell's comparison are
``limits/<cell>.json``. A per-layer metric is ``metrics/<name>.py``, whose
``read(ctx)`` returns its value or None where the run has nothing for it
to read.

The architecture is the configuration's ``embedder.kind``, a module
``embedders/<kind>.py``. For serving it gives the served model's leaves
(``shapes``), the port's embedder (``program``), the reference's forward
pass (``reference``) and the count of one crop (``macs``); a kind that
trains also gives the trained model's leaves and trainable names
(``train_shapes``, ``train_param_names``), the port's train state and step
(``train_program``), the reference's loss and BatchNorm running update
(``train_loss``, ``update_running``) and the count of one training image
(``train_macs``). The optimizer is the configuration's, by name, in
``reference/optim.py``. So a new architecture adds files and edits none:
``embedders/<kind>.py``, ``reference/<arch>.py``, ``configs/<config>.json``,
``limits/<cell>.json``, ``traffic/<mix>.json`` where the mix is new,
``metrics/<name>.py`` for a new metric, and its entries in
``BENCHMARK.json``, the cell's name appended to each metric's ``workloads``
list."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "facerec_tpu")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, spec: dict | None = None) -> dict:
    """The cell ``name`` with what it names: {"workload", "config",
    "traffic", "limits", "end_to_end", "per_layer"}."""
    spec = spec if spec is not None else load_spec()
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    limits_path = HERE / "limits" / f"{name}.json"
    return {"workload": w, "config": read_json(ROOT / cfg_entry["file"]),
            "traffic": read_json(HERE / "traffic" / f"{w['traffic']}.json"),
            "limits": read_json(limits_path) if limits_path.exists() else {},
            "end_to_end": e2e, "per_layer": per_layer}


def driver(traffic: dict):
    return importlib.import_module(f"perfbench.drivers.{traffic['driver']}")


def read_metric(name: str, ctx: dict):
    """The per-layer metric ``name`` read by ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"perfbench_metric:{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(ctx)


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: dict | None = None) -> str:
    """The last line of standard output; ``checks`` (each number compared
    beside its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def check_lines(checks: dict) -> list[str]:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def decide(limits: dict, numbers: dict, failed: int) -> tuple[bool, dict]:
    """(correct, checks): every number that has a limit, beside it; correct
    where each is finite and within its limit and no request failed."""
    checks = {k: {"value": _finite(numbers.get(k, math.nan)), "limit": lim}
              for k, lim in limits.items()}
    correct = (bool(limits) and failed == 0
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    return correct, checks


def emit(cell: dict, out: dict, traced: bool) -> int:
    """Print the run's result line and, last on standard error, the numbers
    compared; returns the exit code. ``out`` holds the driver's end-to-end
    values by name, ``ctx`` for the per-layer readers, ``numbers`` its
    comparison, ``attempted``, ``failed`` and ``memory_peak_bytes``, and
    ``forbidden``, what the processes that ran the window on its behalf
    loaded of JAX or the JAX package."""
    import torch

    from perfbench import trace

    bad = sorted(set(forbidden_modules()) | set(out.get("forbidden", ())))
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    ctx = out["ctx"]
    if traced:
        metrics = {}
        for m in cell["per_layer"]:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["workload"]["chips"]),
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    brk = None
    if traced:
        prof = ctx["profile"]
        device["busy_s"], device["window_s"] = prof["busy_s"], prof["window_s"]
        brk = trace.breakdown(prof)
    correct, checks = decide(cell["limits"], out["numbers"], out["failed"])
    print(result_line(correct, out["attempted"], out["failed"], metrics, device, checks, brk),
          flush=True)
    if "check_s" in out:
        print(f"perfbench: the comparison took {out['check_s']:.1f} s", file=sys.stderr)
    print("\n".join(check_lines(checks)), file=sys.stderr, flush=True)
    return 0
