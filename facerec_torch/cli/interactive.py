"""Interactive menu (counterpart of ``facerec_tpu/cli/interactive.py``;
reference src/interactive.py:78-974).

The same 9 options: preprocess, preprocessing visualization, train (the
full wizard), evaluate, the hyperopt wizard, cross-validation (with warm
start), compare-all, download, exit. Every wizard builds the typed configs
the command line builds, and every action runs on the menu's ``device``
(default: the CUDA card). Download is not ported: it needs the network.

    python -m facerec_torch.cli.main [--device cpu] interactive
"""

from __future__ import annotations

import json

from facerec_torch import config as C
from facerec_torch import is_device_error
from facerec_torch.config import (
    ArcFaceConfig, EvalConfig, OptimizerConfig, PreprocessingConfig, SchedulerConfig, TrainConfig,
    TuningConfig, logger,
)
from facerec_torch.models import MODEL_TYPES


def _ask(prompt: str, default: str = "") -> str:
    try:
        v = input(f"{prompt}{f' [{default}]' if default else ''}: ").strip()
    except EOFError:
        return default
    return v or default


def _ask_float(prompt: str, default: float) -> float:
    try:
        return float(_ask(prompt, str(default)))
    except ValueError:
        return default


def _ask_int(prompt: str, default: int) -> int:
    try:
        return int(_ask(prompt, str(default)))
    except ValueError:
        return default


def _ask_bool(prompt: str, default: bool = True) -> bool:
    v = _ask(prompt + " (y/n)", "y" if default else "n").lower()
    return v.startswith("y")


def _choose(prompt: str, options: list[str], default: int = 0) -> str:
    print(prompt)
    for i, o in enumerate(options):
        print(f"  {i + 1}. {o}")
    try:
        idx = int(_ask("choice", str(default + 1))) - 1
    except ValueError:
        idx = default
    return options[max(0, min(idx, len(options) - 1))]


def _choose_dataset() -> str:
    candidates = sorted(str(p.parent) for p in C.PROC_DATA_DIR.glob("**/train") if p.is_dir())
    if not candidates:
        return _ask("processed dataset dir (with train/val/test)")
    return _choose("Select dataset:", candidates)


def _train_wizard() -> tuple[TrainConfig, str]:
    """Full-depth train wizard (reference interactive.py:249-452): model
    name, optimizer details, per-scheduler parameters, gradient-clip value,
    early-stopping patience + min-delta, and the ArcFace block including the
    two-phase switch epoch. Can express every TrainConfig field the CLI's
    ``train`` subcommand can."""
    model_type = _choose("Model type:", MODEL_TYPES)
    ds = _choose_dataset()
    model_name = _ask("model name (empty = automatic versioning)") or None
    epochs = _ask_int("epochs", 50)
    batch = _ask_int("batch size", 16)
    image_size = _ask_int("image size", 224 if model_type != "arcface" else 160)
    use_lr_finder = _ask_bool("run LR finder first", False)
    lr = 1e-3 if use_lr_finder else _ask_float("learning rate", 1e-3)
    weight_decay = _ask_float("weight decay", 1e-4)
    opt_name = _choose("Optimizer:", ["adam", "adamw", "radam", "sgd"],
                       default=1 if model_type == "arcface" else 0)

    sched_name = _choose("Scheduler:", ["cosine", "warmup_cosine", "plateau", "step",
                                        "one_cycle", "exponential", "constant"],
                         default=1 if model_type == "arcface" else 0)
    sched_kw: dict = {"name": sched_name}
    if sched_name == "plateau":  # reference interactive.py:370-373
        sched_kw["plateau_patience"] = _ask_int("plateau patience", 5)
        sched_kw["plateau_factor"] = _ask_float("plateau factor", 0.5)
    elif sched_name == "step":
        sched_kw["step_size"] = _ask_int("step size (epochs)", 10)
        sched_kw["gamma"] = _ask_float("step gamma", 0.1)
    elif sched_name in ("warmup_cosine", "one_cycle"):
        sched_kw["warmup_epochs"] = _ask_int("warm-up epochs", 5)
        if sched_name == "one_cycle":
            mx = _ask_float("one-cycle max LR (0 = 10x base)", 0.0)
            sched_kw["one_cycle_max_lr"] = mx or None
    if sched_name not in ("constant",):
        sched_kw["min_lr"] = _ask_float("minimum LR", 1e-6)

    clip = _ask_bool("use gradient clipping", True)
    clip_norm = _ask_float("max gradient norm", 1.0) if clip else 1.0
    early = _ask_bool("early stopping", True)
    patience = _ask_int("early-stopping patience", 10) if early else 10
    min_delta = _ask_float("early-stopping min delta", 0.0) if early else 0.0

    arc = ArcFaceConfig()
    label_smoothing = 0.1
    if model_type == "arcface":
        print("\nArcFace-specific parameters:")
        two_phase = _ask_bool("two-phase training (freeze backbone, then fine-tune)", True)
        arc = ArcFaceConfig(
            margin=_ask_float("arcface margin", 0.5),
            scale=_ask_float("arcface scale", 32.0),
            easy_margin=_ask_bool("easy margin", True),
            progressive_margin=_ask_bool("progressive margin", True),
            two_phase=two_phase,
            two_phase_epoch=(_ask_int("two-phase switch epoch (-1 = epochs/3)", -1)
                             if two_phase else -1),
            warmup_epochs=_ask_int("margin warmup epochs", 10),
            label_smoothing=_ask_float("arcface label smoothing", 0.05),
        )
    else:
        label_smoothing = _ask_float("label smoothing", 0.1)

    opt = OptimizerConfig(name=opt_name, amsgrad=model_type == "arcface",
                          learning_rate=lr, weight_decay=weight_decay,
                          use_grad_clip=clip, grad_clip_norm=clip_norm)
    cfg = TrainConfig(model_type=model_type, model_name=model_name, epochs=epochs,
                      batch_size=batch, image_size=image_size,
                      optimizer=opt, scheduler=SchedulerConfig(**sched_kw),
                      arcface=arc, early_stopping=early, patience=patience,
                      min_delta=min_delta, label_smoothing=label_smoothing,
                      seed=_ask_int("seed", 42),
                      checkpoint_every=_ask_int("checkpoint every N epochs (0 = off)", 0),
                      resume=_ask_bool("resume from latest epoch checkpoint", False),
                      use_lr_finder=use_lr_finder)
    return cfg, ds


def interactive_menu(device: str | None = None) -> int:
    """The menu loop on ``device``; returns 0 at Exit (or end of input). A
    failed action is logged and the menu goes on, except after a CUDA
    error, which may leave the card unusable: that one is raised."""
    from facerec_torch import resolve_device

    dev = resolve_device(device)
    options = [
        "Preprocess raw data",
        "Preprocessing visualization",
        "Train a model",
        "Evaluate a model",
        "Hyperparameter tuning",
        "Cross-validation",
        "Compare all models",
        "Download datasets",
        "Exit",
    ]
    while True:
        print(f"\n=== Face Recognition ({dev}) ===")
        for i, o in enumerate(options):
            print(f"  {i + 1}. {o}")
        choice = _ask("choice", "9")
        try:
            idx = int(choice)
        except ValueError:
            continue
        try:
            if idx == 1:
                from facerec_torch.data.preprocess import process_raw_data

                cfg = PreprocessingConfig(
                    name=_ask("config name", "default"),
                    use_mtcnn=_ask_bool("use MTCNN detection", True),
                    face_margin=_ask_float("face margin", 0.4),
                    augment=_ask_bool("augment", True),
                )
                cap = _ask("max samples per class (empty = all)", "")
                out = process_raw_data(config=cfg,
                                       max_samples_per_class=int(cap) if cap else None,
                                       test_mode=_ask_bool("test mode (3 persons)", False),
                                       device=dev)
                print(f"processed -> {out}")
            elif idx == 2:
                from facerec_torch.data.datasets import ImageFolderIndex
                from facerec_torch.eval.engine import _load_model_for_eval, discover_test_dir
                from facerec_torch.eval.visualizer import generate_visualization_report

                mt = _choose("Model type:", MODEL_TYPES)
                name = _ask("model name", mt)
                test_dir = discover_test_dir(_choose_dataset())
                nc = ImageFolderIndex.build(test_dir).num_classes
                model = _load_model_for_eval(mt, name, nc, C.CHECKPOINTS_DIR, dev)
                print(json.dumps(generate_visualization_report(model, mt, test_dir, device=dev),
                                 indent=2))
            elif idx == 3:
                from facerec_torch.train.engine import train_model

                cfg, ds = _train_wizard()
                out = train_model(cfg, ds, device=dev)
                print(json.dumps(out["summary"], indent=2, default=str))
            elif idx == 4:
                from facerec_torch.eval.engine import evaluate_model

                mt = _choose("Model type:", MODEL_TYPES)
                cfg = EvalConfig(model_type=mt, model_name=_ask("model name", mt))
                res = evaluate_model(cfg, _choose_dataset(), device=dev)
                print(json.dumps({k: v for k, v in res.items()
                                  if isinstance(v, (int, float, str))}, indent=2))
            elif idx == 5:
                from facerec_torch.train.tuning import run_hyperparameter_tuning

                mt = _choose("Model type:", MODEL_TYPES)
                trials = _ask_int("trials", 50 if mt == "arcface" else 20)  # reference interactive.py:553
                tcfg = TuningConfig(model_type=mt, n_trials=trials,
                                    epochs_per_trial=_ask_int("epochs per trial", 12),
                                    train_best=_ask_bool("train best config after", False))
                res = run_hyperparameter_tuning(tcfg, _choose_dataset(), device=dev)
                print(json.dumps({k: res[k] for k in ("best_value", "best_params")}, indent=2))
            elif idx == 6:
                from facerec_torch.train.cross_validation import run_cross_validation

                mt = _choose("Model type:", MODEL_TYPES)
                warm = _ask("warm-start model name (empty = none)", "")
                res = run_cross_validation(TrainConfig(model_type=mt), _choose_dataset(),
                                           n_splits=_ask_int("folds", 5),
                                           epochs_per_fold=_ask_int("epochs per fold", 15),
                                           warm_start_model=warm or None, device=dev)
                print(json.dumps({k: v for k, v in res.items() if k != "fold_results"}, indent=2))
            elif idx == 7:
                from facerec_torch.cli.compare import compare_all_models

                compare_all_models(_choose_dataset(), epochs=_ask_int("epochs per model", 10),
                                   device=dev)
            elif idx == 8:
                from facerec_torch.cli.main import NOT_PORTED

                print(f"download is not ported: {NOT_PORTED['download']}")
            elif idx == 9:
                return 0
        except KeyboardInterrupt:
            print("\ninterrupted")
        except Exception as e:
            if is_device_error(e):
                raise
            logger.exception("menu action failed: %s", e)
