"""Native hyperparameter tuner (counterpart of ``facerec_tpu/train/tuning.py``).

A first-party study engine, as the JAX package's (no Optuna):
  * ``TRIAL0_BASELINES``, the hand-tuned per-model first trials;
  * the same search space: batch-size menu, log-uniform LR inside per-model
    clamps (narrowed around an LR-finder suggestion when there is one),
    optimizer and scheduler menus, dropout, and the ArcFace subspace;
  * the same SQLite trials table, so a study file written by either
    package resumes in the other; every draw from one
    ``np.random.default_rng(seed)`` in JAX's order and with its casts, so
    both packages sample the same trials;
  * median pruning on the per-epoch reports, TPE-lite sampling after 8
    completed trials, ``results.json``, ``study_summary.txt`` and the
    optional ``train_best`` hand-off.

Each trial trains on ``device`` with the port's train and eval steps; the
per-epoch val accuracy is the objective (maximised). Over a mesh of
several ranks (the base config's ``mesh``, as ``train_model``) every trial
trains data-parallel and every rank draws the same trials from the same
history: rank 0 alone writes the study's SQLite file and the results, the
other ranks keep their trials table in memory, started from a copy of the
file. As in JAX, a trial
that raises is recorded as ``FAIL`` and the study goes on, except after a
CUDA error: the card's context may be lost, so the study records the
``FAIL`` row and raises.
"""

from __future__ import annotations

import functools
import json
import math
import sqlite3
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from facerec_torch import is_device_error
from facerec_torch.config import ArcFaceConfig, OptimizerConfig, SchedulerConfig, TrainConfig, TuningConfig, logger
from facerec_torch.parallel.collectives import broadcast_object
from facerec_torch.parallel.mesh import Mesh, build_mesh, shard_params
from facerec_torch.train.engine import _quiet

TRIAL0_BASELINES: dict[str, dict[str, Any]] = {
    "hybrid": {"batch_size": 32, "learning_rate": 3e-4, "weight_decay": 1e-4,
               "dropout": 0.3, "scheduler": "cosine", "optimizer": "adam"},
    "arcface": {"batch_size": 32, "learning_rate": 3e-4, "weight_decay": 1e-3,
                "dropout": 0.3, "scheduler": "warmup_cosine", "optimizer": "adamw",
                "amsgrad": True, "arcface_margin": 0.15, "arcface_scale": 14.0,
                "label_smoothing": 0.15, "warmup_epochs": 25, "clip_grad_norm": 0.3,
                "use_grad_clip": True, "progressive_margin": True, "easy_margin": True},
    "cnn": {"batch_size": 64, "learning_rate": 1e-3, "weight_decay": 1e-5,
            "dropout": 0.35, "scheduler": "one_cycle", "optimizer": "adam"},
    "baseline": {"batch_size": 32, "learning_rate": 5e-3, "weight_decay": 1e-4,
                 "dropout": 0.5, "scheduler": "plateau", "optimizer": "adam"},
    "siamese": {"batch_size": 32, "learning_rate": 1e-4, "weight_decay": 2e-4,
                "dropout": 0.3, "scheduler": "cosine", "optimizer": "adam"},
    "attention": {"batch_size": 48, "learning_rate": 5e-4, "weight_decay": 2e-4,
                  "dropout": 0.25, "scheduler": "cosine", "optimizer": "adam"},
    "ensemble": {"batch_size": 32, "learning_rate": 5e-4, "weight_decay": 2e-4,
                 "dropout": 0.2, "scheduler": "cosine", "optimizer": "adam"},
}

# Per-model LR clamps (reference :634-661)
LR_RANGES = {
    "arcface": (1e-5, 1e-3),
    "siamese": (1e-5, 3e-3),
    "default": (1e-5, 1e-2),
}


class TrialPruned(Exception):
    pass


class Study:
    """Minimal Optuna-like study: trials table in SQLite (resumable)."""

    def __init__(self, name: str, storage: str | Path | None = None, seed: int = 0,
                 replica_of: str | Path | None = None):
        """``replica_of``: keep the trials table in memory, starting from a
        copy of that study file (a rank that does not write it)."""
        self.name = name
        self.rng = np.random.default_rng(seed)
        self.db = sqlite3.connect(str(storage) if storage else ":memory:")
        if replica_of is not None and Path(replica_of).exists():
            src = sqlite3.connect(f"file:{replica_of}?mode=ro", uri=True)
            try:
                src.backup(self.db)
            finally:
                src.close()
        self.db.execute(
            "CREATE TABLE IF NOT EXISTS trials (study TEXT, number INTEGER, state TEXT,"
            " value REAL, params TEXT, reports TEXT, started REAL, finished REAL)"
        )
        self.db.commit()

    # -- persistence ------------------------------------------------------------
    def _rows(self) -> list[tuple]:
        return list(self.db.execute(
            "SELECT number, state, value, params, reports FROM trials WHERE study=? ORDER BY number",
            (self.name,)))

    @property
    def trials(self) -> list[dict]:
        return [
            {"number": n, "state": s, "value": v,
             "params": json.loads(p) if p else {}, "reports": json.loads(r) if r else []}
            for n, s, v, p, r in self._rows()
        ]

    def next_trial_number(self) -> int:
        rows = self._rows()
        return rows[-1][0] + 1 if rows else 0

    def record(self, number: int, state: str, value: float | None, params: dict, reports: list) -> None:
        self.db.execute("DELETE FROM trials WHERE study=? AND number=?", (self.name, number))
        self.db.execute(
            "INSERT INTO trials VALUES (?,?,?,?,?,?,?,?)",
            (self.name, number, state, value, json.dumps(params), json.dumps(reports),
             time.time(), time.time()),
        )
        self.db.commit()

    @property
    def best_trial(self) -> dict | None:
        done = [t for t in self.trials if t["state"] == "COMPLETE" and t["value"] is not None]
        return max(done, key=lambda t: t["value"]) if done else None

    # -- pruning ------------------------------------------------------------------
    def median_prune(self, step: int, value: float, warmup_trials: int = 4) -> bool:
        """Prune if value at `step` is below the median of completed trials'
        values at the same step (Optuna MedianPruner semantics)."""
        hist = []
        for t in self.trials:
            if t["state"] in ("COMPLETE", "PRUNED") and len(t["reports"]) > step:
                hist.append(t["reports"][step])
        if len(hist) < warmup_trials:
            return False
        return value < float(np.median(hist))

    # -- sampling -------------------------------------------------------------------
    @staticmethod
    def lr_window(model_type: str, lr_center: float | None = None, span: float = 5.0) -> tuple[float, float]:
        """The log-uniform LR window: the per-model clamp, narrowed around the
        LR-finder suggestion when one is available (reference
        hyperparameter_tuning.py:634-661)."""
        clamp_lo, clamp_hi = LR_RANGES.get(model_type, LR_RANGES["default"])
        lo, hi = clamp_lo, clamp_hi
        if lr_center is not None and lr_center > 0:
            lo = max(clamp_lo, lr_center / span)
            hi = min(clamp_hi, lr_center * span)
            if lo >= hi:  # suggestion outside the clamp: hug the nearest edge
                if lr_center >= clamp_hi:
                    lo, hi = max(clamp_lo, clamp_hi / span), clamp_hi
                else:
                    lo, hi = clamp_lo, min(clamp_hi, clamp_lo * span)
        return lo, hi

    def suggest(self, model_type: str, trial_number: int, use_trial0: bool = True,
                lr_center: float | None = None, lr_span: float = 5.0,
                sampler: str = "tpe-lite") -> dict[str, Any]:
        if trial_number == 0 and use_trial0 and model_type in TRIAL0_BASELINES:
            return dict(TRIAL0_BASELINES[model_type])
        done = [t for t in self.trials if t["state"] == "COMPLETE" and t["value"] is not None]
        if sampler == "tpe-lite" and len(done) >= 8 and self.rng.random() < 0.5:
            # TPE-lite: perturb a top-quartile trial
            done.sort(key=lambda t: -t["value"])
            base = dict(self.rng.choice(done[: max(len(done) // 4, 1)])["params"])
            base["learning_rate"] = float(np.clip(
                base.get("learning_rate", 1e-3) * math.exp(self.rng.normal(0, 0.5)),
                *self.lr_window(model_type, lr_center, lr_span)))
            base["weight_decay"] = float(np.clip(
                base.get("weight_decay", 1e-4) * math.exp(self.rng.normal(0, 0.5)), 1e-6, 1e-2))
            base["dropout"] = float(np.clip(base.get("dropout", 0.3) + self.rng.normal(0, 0.05), 0.0, 0.7))
            return base
        return self._random_params(model_type, lr_center, lr_span)

    def _random_params(self, model_type: str, lr_center: float | None = None,
                       lr_span: float = 5.0) -> dict[str, Any]:
        r = self.rng
        lo, hi = self.lr_window(model_type, lr_center, lr_span)
        p = {
            "batch_size": int(r.choice([8, 16, 32, 64])),
            "learning_rate": float(np.exp(r.uniform(np.log(lo), np.log(hi)))),
            "weight_decay": float(r.choice([1e-5, 1e-4, 1e-3])),
            "scheduler": str(r.choice(["plateau", "cosine", "step", "constant"])),
            "optimizer": str(r.choice(["adam", "adamw", "radam", "sgd"])),
            "dropout": float(r.uniform(0.1, 0.6)),
            "use_grad_clip": bool(r.choice([True, False])),
            "clip_grad_norm": float(r.choice([0.5, 1.0, 3.0, 5.0])),
        }
        if model_type == "arcface":
            # ArcFace-specific subspace (reference :686-756); clipping and
            # warmup are forced on for stability as the reference does.
            p.update({
                "arcface_margin": float(r.uniform(0.1, 0.3)),
                "arcface_scale": float(r.uniform(12.0, 18.0)),
                "easy_margin": bool(r.choice([True, False])),
                "progressive_margin": True,
                "label_smoothing": float(r.uniform(0.05, 0.15)),
                "warmup_epochs": int(r.integers(5, 16)),
                "use_grad_clip": True,
                "clip_grad_norm": float(r.uniform(0.1, 1.0)),
                "scheduler": "warmup_cosine",
                "optimizer": "adamw",
                "amsgrad": True,
            })
        if model_type == "hybrid":
            p["label_smoothing"] = float(r.uniform(0.05, 0.15))
        return p


def params_to_config(model_type: str, params: dict[str, Any], base: TrainConfig) -> TrainConfig:
    opt = OptimizerConfig(
        name=params.get("optimizer", "adam"),
        learning_rate=params.get("learning_rate", 1e-3),
        weight_decay=params.get("weight_decay", 1e-4),
        amsgrad=params.get("amsgrad", False),
        use_grad_clip=params.get("use_grad_clip", True),
        grad_clip_norm=params.get("clip_grad_norm", 1.0),
    )
    sched = SchedulerConfig(name=params.get("scheduler", "cosine"),
                            warmup_epochs=params.get("warmup_epochs", 0))
    arc = ArcFaceConfig(
        margin=params.get("arcface_margin", 0.5),
        scale=params.get("arcface_scale", 32.0),
        easy_margin=params.get("easy_margin", True),
        progressive_margin=params.get("progressive_margin", True),
        warmup_epochs=params.get("warmup_epochs", 10),
        label_smoothing=params.get("label_smoothing", 0.05),
    )
    return base.replace(
        model_type=model_type,
        batch_size=int(params.get("batch_size", base.batch_size)),
        optimizer=opt, scheduler=sched, arcface=arc,
        dropout_rate=params.get("dropout"),
    )


def run_hyperparameter_tuning(
    tuning: TuningConfig,
    dataset_dir: str | Path,
    base_config: TrainConfig | None = None,
    output_dir: str | Path | None = None,
    objective_fn: Callable[[TrainConfig, Any], list[float]] | None = None,
    lr_finder_fn: Callable[..., dict] | None = None,
    device: str | torch.device | None = None,
    mesh: Mesh | None = None,
) -> dict[str, Any]:
    """Run the study on ``device`` (default: the CUDA card), over ``mesh``
    (default: the base config's ``mesh`` over the process group's ranks).
    ``objective_fn(config, report) -> per-epoch val accs`` defaults to a
    short real training run and ``lr_finder_fn(dataset_dir, config,
    tuning) -> analysis`` to a real range test; both are injectable."""
    from facerec_torch.config import OUTPUTS_DIR

    base = base_config or TrainConfig(model_type=tuning.model_type)
    mesh = mesh if mesh is not None else build_mesh(base.mesh, device=device)
    dev = mesh.device
    log = logger.info if mesh.is_primary else _quiet
    out_dir = Path(output_dir or (OUTPUTS_DIR / "hyperopt" / broadcast_object(
        f"{tuning.model_type}_{int(time.time())}", mesh)))
    storage = tuning.storage or str(out_dir / "study.sqlite")
    if mesh.is_primary:
        out_dir.mkdir(parents=True, exist_ok=True)
        study = Study(tuning.study_name, storage, seed=tuning.seed)
    mesh.barrier()  # the study file exists before another rank copies it
    if not mesh.is_primary:
        study = Study(tuning.study_name, None, seed=tuning.seed, replica_of=storage)
    start = time.time()

    if objective_fn is None:
        objective_fn = _default_objective(dataset_dir, tuning, dev, mesh)
    if lr_finder_fn is None:
        lr_finder_fn = functools.partial(_run_lr_finder, device=dev, mesh=mesh)

    # LR-finder pre-pass: one range test on the base config centres the LR
    # search window for every sampled trial
    lr_center = None
    if tuning.use_lr_finder and not tuning.use_lr_finder_per_trial:
        try:
            analysis = lr_finder_fn(dataset_dir, base, tuning)
            if mesh.is_primary:
                (out_dir / "lr_finder.json").write_text(json.dumps(
                    {k: v for k, v in analysis.items() if not isinstance(v, (list, np.ndarray))},
                    indent=2))
            if analysis.get("valid"):
                lr_center = float(analysis["suggested_lr"])
                lo, hi = Study.lr_window(tuning.model_type, lr_center, tuning.lr_finder_span)
                log("LR finder suggests %.3e -> search window [%.2e, %.2e]", lr_center, lo, hi)
        except Exception as e:
            if is_device_error(e):
                raise
            logger.warning("LR-finder pre-pass failed (%s); using the default window", e)

    completed = [t for t in study.trials if t["state"] in ("COMPLETE", "PRUNED")]
    log("study '%s': %d existing trials (resume)", tuning.study_name, len(completed))

    n_new = max(tuning.n_trials - len(completed), 0)
    for _ in range(n_new):
        if tuning.timeout_seconds and time.time() - start > tuning.timeout_seconds:
            log("tuning timeout reached")
            break
        number = study.next_trial_number()
        params = study.suggest(tuning.model_type, number, tuning.use_trial0_baseline,
                               lr_center=lr_center, lr_span=tuning.lr_finder_span,
                               sampler=getattr(tuning, "sampler", "tpe-lite"))
        cfg = params_to_config(tuning.model_type, params, base)
        if tuning.use_lr_finder_per_trial:
            # the range test inside the trial, on the trial's own config
            # (batch size and optimizer shift the usable LR range); the
            # trial's LR is resampled from its own window
            try:
                analysis = lr_finder_fn(dataset_dir, cfg, tuning)
                if analysis.get("valid"):
                    lo, hi = Study.lr_window(tuning.model_type,
                                             float(analysis["suggested_lr"]),
                                             tuning.lr_finder_span)
                    params = dict(params)
                    params["learning_rate"] = float(
                        np.exp(study.rng.uniform(np.log(lo), np.log(hi))))
                    params["lr_finder_suggested"] = float(analysis["suggested_lr"])
                    cfg = params_to_config(tuning.model_type, params, base)
                    log("trial %d LR finder: %.3e -> window [%.2e, %.2e], lr=%.3e",
                        number, analysis["suggested_lr"], lo, hi, params["learning_rate"])
            except Exception as e:
                if is_device_error(e):
                    raise
                logger.warning("trial %d LR finder failed (%s); keeping sampled LR",
                               number, e)
        reports: list[float] = []

        def report(epoch: int, value: float) -> None:
            reports.append(value)
            if tuning.pruning and epoch >= tuning.pruning_warmup_epochs:
                if study.median_prune(epoch, value):
                    raise TrialPruned()

        try:
            values = objective_fn(cfg, report)
            best = max(values) if values else 0.0
            study.record(number, "COMPLETE", best, params, reports or values)
            log("trial %d COMPLETE val_acc=%.4f %s", number, best,
                {k: round(v, 5) if isinstance(v, float) else v for k, v in params.items()})
        except TrialPruned:
            study.record(number, "PRUNED", max(reports) if reports else None, params, reports)
            log("trial %d PRUNED after %d epochs", number, len(reports))
        except Exception as e:  # failed trial: record and continue (optuna semantics)
            study.record(number, "FAIL", None, params, reports)
            logger.warning("trial %d FAILED: %s", number, e)
            if is_device_error(e):
                raise

    best = study.best_trial
    summary = {
        "study_name": tuning.study_name,
        "model_type": tuning.model_type,
        "n_trials": len(study.trials),
        "best_value": best["value"] if best else None,
        "best_params": best["params"] if best else None,
        "storage": str(storage),
        "elapsed_sec": round(time.time() - start, 1),
        "trials": [{k: t[k] for k in ("number", "state", "value", "params")} for t in study.trials],
    }
    if mesh.is_primary:
        (out_dir / "results.json").write_text(json.dumps(summary, indent=2))
        lines = [f"Study {tuning.study_name}: {len(study.trials)} trials"]
        if best:
            lines.append(f"Best value: {best['value']:.4f} (trial {best['number']})")
            lines += [f"  {k}: {v}" for k, v in best["params"].items()]
        (out_dir / "study_summary.txt").write_text("\n".join(lines))

    if tuning.train_best and best:
        from facerec_torch.train.engine import train_model

        cfg = params_to_config(tuning.model_type, best["params"], base)
        summary["train_best"] = train_model(cfg, dataset_dir, device=dev, mesh=mesh)["summary"]
    mesh.barrier()
    return summary


def _run_lr_finder(dataset_dir: str | Path, base: TrainConfig, tuning: TuningConfig,
                   device: str | torch.device | None = None, mesh: Mesh | None = None) -> dict:
    """One LR range test on the base config: 60 steps on a probe model of
    its own, initialised from ``tuning.seed + 99``, over the trainer's own
    train batcher (data-parallel over ``mesh``)."""
    from facerec_torch.models import get_model
    from facerec_torch.train.engine import _make_batchers, mesh_for
    from facerec_torch.train.lr_finder import find_optimal_lr
    from facerec_torch.train.state import create_train_state

    cfg = base.replace(model_type=tuning.model_type)
    mesh = mesh_for(cfg, device, mesh)
    batchers, num_classes = _make_batchers(Path(dataset_dir), cfg)
    model = get_model(cfg.model_type, num_classes=num_classes, dropout_rate=cfg.dropout_rate)
    state = create_train_state(model, cfg.replace(seed=tuning.seed + 99), cfg.model_type,
                               mesh.device)
    shard_params(model, mesh)
    return find_optimal_lr(model, cfg.model_type, state, batchers["train"], num_steps=60,
                           compute_dtype=cfg.compute_dtype, mesh=mesh)


def _default_objective(dataset_dir: str | Path, tuning: TuningConfig,
                       device: str | torch.device | None = None, mesh: Mesh | None = None):
    """A trial: ``tuning.epochs_per_trial`` epochs of the trial's config,
    data-parallel over ``mesh`` (default: one rank on ``device``)."""
    def objective(cfg: TrainConfig, report) -> list[float]:
        from facerec_torch.models import get_model
        from facerec_torch.train.engine import _make_batchers, _run_epoch, mesh_for
        from facerec_torch.train.schedulers import get_scheduler
        from facerec_torch.train.state import create_train_state, set_hyperparam
        from facerec_torch.train.steps import make_eval_step, make_train_step

        batchers, num_classes = _make_batchers(Path(dataset_dir), cfg)
        model = get_model(cfg.model_type, num_classes=num_classes, dropout_rate=cfg.dropout_rate,
                          arcface_kwargs=dict(margin=cfg.arcface.margin, scale=cfg.arcface.scale,
                                              easy_margin=cfg.arcface.easy_margin,
                                              progressive_margin=cfg.arcface.progressive_margin,
                                              warmup_epochs=cfg.arcface.warmup_epochs)
                          if cfg.model_type == "arcface" else None)
        trial_mesh = mesh_for(cfg, device, mesh)
        dev = trial_mesh.device
        state = create_train_state(model, cfg.replace(seed=tuning.seed), cfg.model_type, dev)
        shard_params(model, trial_mesh)
        train_step = make_train_step(cfg.model_type, cfg.compute_dtype, trial_mesh)
        eval_step = make_eval_step(cfg.model_type, cfg.compute_dtype, mesh=trial_mesh)
        sched = get_scheduler(cfg.scheduler, cfg.optimizer.learning_rate, tuning.epochs_per_trial)
        lr = sched.step()
        set_hyperparam(state.opt_state, "learning_rate", lr)
        accs = []
        for epoch in range(tuning.epochs_per_trial):
            state.epoch = float(epoch)
            _run_epoch(train_step, state, batchers["train"], dev, epoch, True,
                       prefetch=cfg.prefetch_depth, mesh=trial_mesh)
            vb = batchers["val"] or batchers["train"]
            val = _run_epoch(eval_step, state, vb, dev, epoch, False, prefetch=cfg.prefetch_depth,
                             mesh=trial_mesh)
            accs.append(val["acc"])
            report(epoch, val["acc"])
            lr = sched.step(val["loss"])
            set_hyperparam(state.opt_state, "learning_rate", lr)
        return accs

    return objective
