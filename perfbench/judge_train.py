"""The comparison that decides ``correct`` in a train cell: the program's
first steps, which the window's own call and feed drove, against the plain
reference following the same steps from the same weights, batches and
dropout draws: the loss and the BatchNorm running update of the embedder
kind's module (``embedders/<kind>.py``, which points at its reference), the
optimizer the configuration names (``reference/optim.py``).

A leaf's gap is the gap between the program's norm of the leaf and the
reference's, over the larger of the reference's norm of that leaf and of
the median leaf. The numbers:

* ``loss_gap_first``: the relative gap of the first step's loss
  (``loss_gap``: the widest over the steps).
* ``grad_norm_gap_first``: the relative gap of the first step's global
  gradient norm before the clip (the step's own ``grad_norm``).
* ``grad_gap_median``: the first gradient as the optimizer gets it (before
  the clip: Adam's first moment over 1 - beta1, or SGD's momentum trace,
  which after one step is the clipped gradient, times the clip's factor,
  the step's ``grad_norm`` over the clip norm where that is over 1), the
  median leaf's gap (``grad_gap``: the worst leaf's).
* ``change_gap_median``: the parameters' change over the steps, the median
  leaf's gap (``change_gap``: the worst leaf's).
* ``stats_gap_median``: the BatchNorm running statistics' change over the
  steps (the batch's, over every rank's slice of it, mixed in at 0.1 a
  step), the median buffer's gap (``stats_gap``: the worst buffer's).

In the ResNet-18 cells under Adam the worst leaf is a BatchNorm scale or
shift on every seed: its gradient is a sum over the batch and the pixels
that cancels, and bf16 rounding moves its norm by 5-17% of the median
leaf's; the later steps' losses carry the first steps' rounding through
the optimizer. So the first loss and the median leaf are compared, and the
widest are read.

Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone (Adam scales every leaf's step to about the
learning rate, whatever its gradient) and are left out of both leaf
numbers (``SILENT``); the rule reads the reference's gradient, not names.
The dropout draws follow the configuration's rule: step k draws from a
generator on the device seeded to seed x 1,000,003 + k, one mask of
``embedding_dim`` an example, which ArcFace's head applies to the
embedding after its BatchNorm."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import optim
from perfbench.reference.precision import Precision

SILENT = 1e-3
NUMBERS = ("loss_gap_first", "grad_norm_gap_first", "grad_gap_median", "change_gap_median",
           "stats_gap_median", "loss_gap", "grad_gap", "change_gap", "stats_gap")
RUNNING = ("running_mean", "running_var")


FAULTS = ("half_batch", "no_exchange")


def follow(arch, config: dict, traffic: dict, seed: int, device, pool, precision: str = "f32",
           fault: str = "") -> tuple[dict, dict]:
    """The reference's first steps of the model that ``arch``, the kind's
    module, trains: (p0, {"losses", "grad", "params"}). ``fault`` plants one: ``half_batch``, the loss the mean over the first
    half of each batch only; ``no_exchange``, each step rank 0's alone, on
    its slice of the batch (its own BatchNorm statistics, no gradient
    sum over the ranks)."""
    from perfbench.drivers.train import dropout_seed, model_state

    t = config["train"]
    w = model_state(arch, t, seed, device)
    names = arch.train_param_names(t)
    params = [w[n].clone().requires_grad_(True) for n in names]
    running = {n: v.clone() for n, v in w.items() if n.rsplit(".", 1)[-1] in RUNNING}
    p0 = {n: q.detach().clone() for n, q in zip(names, params)}
    p0.update({n: v.clone() for n, v in running.items()})
    opt = optim.make(params, t["optimizer"])
    p = Precision(precision)
    out = {"losses": [], "grad_norms": [], "grad": None}
    dseed = dropout_seed(seed)
    for k in range(traffic["check_steps"]):
        batch = pool[k % len(pool)]
        images = torch.from_numpy(batch["image"]).to(device)
        labels = torch.from_numpy(batch["label"]).to(device)
        gen = torch.Generator(device=device).manual_seed((dseed * 1_000_003 + k) % (1 << 63))
        keep = torch.rand((images.shape[0], t["embedding_dim"]), generator=gen,
                          device=device) >= t["dropout"]
        if fault == "no_exchange":
            local = images.shape[0] // traffic.get("ranks", 1)
            images, labels, keep = images[:local], labels[:local], keep[:local]
        mask = None
        if fault == "half_batch":
            mask = torch.zeros(images.shape[0], device=device)
            mask[: images.shape[0] // 2] = 1.0
        stats: dict = {}
        loss = arch.train_loss(p, dict(zip(names, params)), images, labels, keep, t,
                               mask=mask, stats=stats)
        arch.update_running(running, stats)
        grads = torch.autograd.grad(loss, params)
        out["grad_norms"].append(float(opt.step(params, list(grads))))
        out["losses"].append(float(loss.detach()))
        if k == 0:
            out["grad"] = {n: torch.nan_to_num(g.detach(), 0.0, 0.0, 0.0)
                           for n, g in zip(names, grads)}
        del loss, grads
    out["params"] = {n: q.detach().clone() for n, q in zip(names, params)}
    out["params"].update(running)
    return p0, out


def _leaf_gaps(prog: dict, ref: dict, keep: list[str]) -> np.ndarray:
    rn = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in keep}
    pn = {n: float(torch.linalg.vector_norm(prog[n].double())) for n in keep}
    med = float(np.median(list(rn.values())))
    return np.array([abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in keep])


def compare(p0: dict, prog: dict, ref: dict) -> dict[str, float]:
    """The numbers for the program's first steps (``prog``) against the
    reference's (``ref``), both from the weights ``p0``."""
    names = list(ref["grad"])
    norms = {n: float(torch.linalg.vector_norm(ref["grad"][n].double())) for n in names}
    med = float(np.median(list(norms.values())))
    keep = [n for n in names if norms[n] >= SILENT * med]
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    bufs = [n for n in ref["params"] if n.rsplit(".", 1)[-1] in RUNNING]

    def change(side, ns):
        return {n: side["params"][n].to(p0[n].device).float() - p0[n] for n in ns}

    gaps = {"grad": _leaf_gaps({n: prog["grad"][n].to(p0[n].device) for n in keep},
                               ref["grad"], keep),
            "change": _leaf_gaps(change(prog, keep), change(ref, keep), keep),
            "stats": _leaf_gaps(change(prog, bufs), change(ref, bufs), bufs)}
    out = {"loss_gap_first": losses[0], "loss_gap": max(losses),
           "grad_norm_gap_first": abs(prog["grad_norms"][0] - ref["grad_norms"][0])
           / max(ref["grad_norms"][0], 1e-30)}
    for k, g in gaps.items():
        out[f"{k}_gap_median"] = float(np.median(g))
        out[f"{k}_gap"] = float(g.max())
    out["silent_leaves"] = float(len(names) - len(keep))
    return out


def judge(arch, config: dict, traffic: dict, seed: int, device, pool, p0_prog: dict,
          prog: dict) -> dict[str, float]:
    """The program's first steps against the reference's."""
    p0, ref = follow(arch, config, traffic, seed, device, pool)
    for n, v in p0.items():  # both sides start from the benchmark's weights
        if not torch.equal(v, p0_prog[n].to(v.device).float()):
            return {k: float("nan") for k in NUMBERS}
    return compare(p0, prog, ref)
