"""The port's tuner (``facerec_torch/train/tuning.py``) against the JAX
package's (``facerec_tpu/train/tuning.py``) on the CPU: the LR window, the
configs built from parameters, the sequence of suggestions from one seed
(random draws, the TPE-lite branch after 8 completed trials, the ArcFace
and hybrid subspaces), whole studies with the same injected objective and
LR finder (pruning, failures, the pre-pass, the per-trial finder), study
files resumed by the other package, and the real objective."""

import json
import math
import shutil
import sqlite3

import pytest
import torch

from facerec_torch.config import SchedulerConfig, TrainConfig, TuningConfig
from facerec_torch.models import get_model
from facerec_torch.train import engine
from facerec_torch.train import tuning as T
from facerec_torch.train.lr_finder import find_optimal_lr
from facerec_torch.train.state import create_train_state
from facerec_tpu.config import TrainConfig as JaxTrainConfig
from facerec_tpu.config import TuningConfig as JaxTuningConfig
from facerec_tpu.train import tuning as JT
from facerec_tpu.train.schedulers import get_scheduler as jax_get_scheduler

MODEL_TYPES = ["baseline", "cnn", "siamese", "attention", "arcface", "hybrid", "ensemble"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_tables_match_jax():
    assert T.TRIAL0_BASELINES == JT.TRIAL0_BASELINES
    assert T.LR_RANGES == JT.LR_RANGES
    assert TuningConfig().to_dict() == JaxTuningConfig().to_dict()


@pytest.mark.parametrize("model_type", ["baseline", "arcface", "siamese", "hybrid"])
def test_lr_window_matches_jax(model_type):
    for center in (None, 0.0, 1e-7, 1e-5, 3e-4, 1e-3, 5e-3, 0.5):
        for span in (2.0, 5.0, 10.0):
            assert (T.Study.lr_window(model_type, center, span)
                    == JT.Study.lr_window(model_type, center, span)), (center, span)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_params_to_config_matches_jax(model_type):
    """The trial-0 baseline and three random draws, onto a 32-px base."""
    study = T.Study("s", None, seed=MODEL_TYPES.index(model_type))
    draws = [T.TRIAL0_BASELINES[model_type]] + [study._random_params(model_type) for _ in range(3)]
    base, jbase = (cls(model_type="baseline", image_size=32, epochs=3) for cls in (TrainConfig,
                                                                                   JaxTrainConfig))
    for params in draws:
        assert (T.params_to_config(model_type, params, base).to_dict()
                == JT.params_to_config(model_type, params, jbase).to_dict())


def _outcome(number: int, params: dict) -> tuple[str, float | None]:
    """A trial's fate from its number and parameters: every fifth fails,
    every seventh is pruned, the rest complete with a value from the LR."""
    if number % 5 == 4:
        return "FAIL", None
    value = max(0.0, 1.0 - abs(math.log10(params["learning_rate"]) + 3.0) / 3.0)
    return ("PRUNED" if number % 7 == 6 else "COMPLETE"), value


@pytest.mark.parametrize("model_type,sampler,center", [
    ("baseline", "tpe-lite", None), ("arcface", "tpe-lite", 3e-4), ("hybrid", "tpe-lite", None),
    ("siamese", "random", 1e-4)])
def test_suggest_sequence_matches_jax(model_type, sampler, center):
    """24 trials drawn by each package's ``Study`` from the same seed and
    the same history: equal parameters, plain Python values only, and the
    TPE-lite branch reached once 8 trials have completed."""
    def run(studies, sampler):
        drawn = []
        for number in range(24):
            ps = [s.suggest(model_type, number, True, lr_center=center, lr_span=5.0,
                            sampler=sampler) for s in studies]
            assert all(p == ps[0] for p in ps), number
            assert all(type(v) in (int, float, str, bool) for v in ps[0].values()), ps[0]
            state, value = _outcome(number, ps[0])
            for s in studies:
                s.record(number, state, value, ps[0], [value] if value is not None else [])
            drawn.append(ps[0])
        return drawn

    study, jstudy = T.Study("s", None, seed=7), JT.Study("s", None, seed=7)
    drawn = run([study, jstudy], sampler)
    assert study.trials == jstudy.trials
    assert len([t for t in study.trials if t["state"] == "COMPLETE"]) >= 8
    if sampler == "tpe-lite":  # the branch ran: a random study draws otherwise
        assert drawn != run([T.Study("s", None, seed=7)], "random")


def _objective(kind: str):
    """The injected objective of each scenario: a function of the config
    alone, so that both packages' trials see the same values."""
    calls = {"n": 0}

    def objective(cfg, report):
        calls["n"] += 1
        if kind == "fail" and (cfg.optimizer.name == "sgd" or cfg.batch_size == 64):
            raise ValueError("this trial fails")
        if kind == "pruning":
            accs = [0.9 if calls["n"] <= 4 else 0.01] * 6
        else:
            q = max(0.0, 1.0 - abs(math.log10(cfg.optimizer.learning_rate) + 3.0) / 3.0)
            accs = [q * (e + 1) / 5 for e in range(5)]
        for e, a in enumerate(accs):
            report(e, a)
        return accs

    return objective


def _finder(dataset_dir, cfg, tuning):
    """A range test whose suggestion follows the trial's batch size."""
    lr = 1e-3 * (cfg.batch_size / 16)
    return {"valid": True, "suggested_lr": lr, "max_lr": 10 * lr, "lrs": [1e-7, lr],
            "losses": [2.3, 1.0]}


SCENARIOS = {
    "pruning": dict(n_trials=8, epochs_per_trial=6, pruning=True, pruning_warmup_epochs=1,
                    use_trial0_baseline=False, seed=1),
    "fail": dict(n_trials=8, seed=0),
    "prepass": dict(n_trials=6, use_lr_finder=True, use_trial0_baseline=False, seed=3),
    "per_trial": dict(n_trials=5, use_lr_finder=True, use_lr_finder_per_trial=True,
                      use_trial0_baseline=False, seed=0),
    "tpe": dict(n_trials=14, pruning=False, seed=2),
}


def _rows(db):
    with sqlite3.connect(db) as con:
        return list(con.execute("SELECT study, number, state, value, params, reports FROM trials "
                                "ORDER BY number"))


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_study_matches_jax(scenario, tmp_path):
    """Each package runs the scenario's study with the same injected
    objective and LR finder: the same trial rows (number, state, value,
    parameters, reports), the same ``results.json`` apart from
    ``elapsed_sec`` and ``storage``, the same summary and pre-pass file."""
    kw = dict(model_type="baseline", study_name="t", **SCENARIOS[scenario])
    out = {}
    for pkg, cfg_cls, run in (("port", TuningConfig, T.run_hyperparameter_tuning),
                              ("jax", JaxTuningConfig, JT.run_hyperparameter_tuning)):
        d = tmp_path / pkg
        extra = {"device": "cpu"} if pkg == "port" else {}
        out[pkg] = run(cfg_cls(storage=str(tmp_path / f"{pkg}.sqlite"), **kw), tmp_path,
                       output_dir=d, objective_fn=_objective(scenario), lr_finder_fn=_finder, **extra)
    assert _rows(tmp_path / "port.sqlite") == _rows(tmp_path / "jax.sqlite")
    drop = lambda r: {k: v for k, v in r.items() if k not in ("elapsed_sec", "storage")}  # noqa: E731
    assert drop(out["port"]) == drop(out["jax"])
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for name in files:
        if name != "results.json":
            assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    saved = json.loads((tmp_path / "port" / "results.json").read_text())
    assert drop(saved) == drop(json.loads((tmp_path / "jax" / "results.json").read_text()))
    states = [t["state"] for t in out["port"]["trials"]]
    assert {"pruning": "PRUNED", "fail": "FAIL"}.get(scenario, "COMPLETE") in states
    if scenario == "prepass":
        assert "lr_finder.json" in files


def test_device_error_ends_the_study(tmp_path):
    """A trial that raises a CUDA error is recorded as FAIL, and the study
    raises instead of carrying on (the card's context may be lost)."""
    def objective(cfg, report):
        if objective.n == 1:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        objective.n += 1
        return [0.5]

    objective.n = 0
    db = tmp_path / "s.sqlite"
    with pytest.raises(RuntimeError, match="CUDA error"):
        T.run_hyperparameter_tuning(TuningConfig(n_trials=5, storage=str(db), seed=0), tmp_path,
                                    output_dir=tmp_path / "o", objective_fn=objective,
                                    device="cpu")
    assert [r[2] for r in _rows(db)] == ["COMPLETE", "FAIL"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_study_files_resume_across_packages(writer, tmp_path):
    """A study of 6 trials written by one package resumes to 11 in the
    other, with the trials the writer itself would have drawn."""
    runs = {"port": (TuningConfig, T.run_hyperparameter_tuning, {"device": "cpu"}),
            "jax": (JaxTuningConfig, JT.run_hyperparameter_tuning, {})}
    reader = "jax" if writer == "port" else "port"
    kw = dict(model_type="arcface", study_name="x", seed=4, pruning=False)

    def run(pkg, db, n, out):
        cfg_cls, fn, extra = runs[pkg]
        return fn(cfg_cls(n_trials=n, storage=str(db), **kw), tmp_path, output_dir=out,
                  objective_fn=_objective("tpe"), **extra)

    run(writer, tmp_path / "a.sqlite", 6, tmp_path / "o1")
    shutil.copy(tmp_path / "a.sqlite", tmp_path / "b.sqlite")
    resumed = run(reader, tmp_path / "a.sqlite", 11, tmp_path / "o2")
    same = run(writer, tmp_path / "b.sqlite", 11, tmp_path / "o3")
    assert resumed["n_trials"] == 11
    assert _rows(tmp_path / "a.sqlite") == _rows(tmp_path / "b.sqlite")
    assert resumed["trials"] == same["trials"]


def test_objective_sets_the_epoch_and_learning_rates(synthetic_imagefolder, monkeypatch):
    """The default objective sets ``state.epoch`` before each epoch (an
    ArcFace trial's margin reads it) and takes JAX's learning rates, and
    reports each epoch's val accuracy."""
    calls = []

    def fake_epoch(step_fn, state, batcher, device, epoch, train, max_batches=0, prefetch=2,
                   mesh=None):
        calls.append((train, epoch, state.epoch, state.opt_state.hyperparams["learning_rate"]))
        return {"loss": 2.0 - 0.1 * epoch, "acc": 0.2 * (epoch + 1)}

    monkeypatch.setattr(engine, "_run_epoch", fake_epoch)
    sched = SchedulerConfig(name="warmup_cosine", warmup_epochs=1)
    cfg = TrainConfig(model_type="arcface", image_size=32, batch_size=8, scheduler=sched)
    tuning = TuningConfig(model_type="arcface", epochs_per_trial=3)
    reports = []
    accs = T._default_objective(synthetic_imagefolder, tuning, "cpu")(
        cfg, lambda e, v: reports.append((e, v)))
    assert accs == [0.2 * (e + 1) for e in range(3)] and reports == list(enumerate(accs))
    assert [(t, e, s) for t, e, s, _ in calls] == [
        (True, 0, 0.0), (False, 0, 0.0), (True, 1, 1.0), (False, 1, 1.0), (True, 2, 2.0),
        (False, 2, 2.0)]
    ref = jax_get_scheduler(sched, cfg.optimizer.learning_rate, 3)
    want = [ref.step()] + [ref.step(2.0 - 0.1 * e) for e in range(2)]
    assert [lr for t, _, _, lr in calls if t] == want


def test_real_objective_and_prepass(synthetic_imagefolder, tmp_path):
    """The default objective and range test, as JAX's
    ``test_tuner_real_objective`` drives them: 2 trials of 1 epoch on a
    32-px baseline with the pre-pass on; the pre-pass is a 60-step sweep of
    a model initialised from ``seed + 99`` over the trainer's batcher."""
    tcfg = TuningConfig(model_type="baseline", n_trials=2, epochs_per_trial=1, pruning=False,
                        seed=3, use_lr_finder=True)
    base = TrainConfig(model_type="baseline", image_size=32, compute_dtype="float32")
    res = T.run_hyperparameter_tuning(tcfg, synthetic_imagefolder, output_dir=tmp_path / "o",
                                      base_config=base, device="cpu")
    assert res["n_trials"] == 2
    assert [t["state"] for t in res["trials"]] == ["COMPLETE", "COMPLETE"]
    assert res["best_value"] is not None and 0.0 <= res["best_value"] <= 1.0
    prepass = json.loads((tmp_path / "o" / "lr_finder.json").read_text())
    assert prepass["valid"] and "lrs" not in prepass
    lo, hi = T.Study.lr_window("baseline", prepass["suggested_lr"], 5.0)
    assert lo <= res["trials"][1]["params"]["learning_rate"] <= hi

    batchers, nc = engine._make_batchers(synthetic_imagefolder, base)
    model = get_model("baseline", num_classes=nc)
    state = create_train_state(model, base.replace(seed=tcfg.seed + 99), "baseline",
                               torch.device("cpu"))
    direct = find_optimal_lr(model, "baseline", state, batchers["train"], num_steps=60,
                             device="cpu", compute_dtype="float32")
    assert direct["suggested_lr"] == prepass["suggested_lr"]
    assert direct["max_lr"] == prepass["max_lr"] and len(direct["lrs"]) <= 60
