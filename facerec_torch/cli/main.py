"""The port's command line (counterpart of ``facerec_tpu/cli/main.py``).

The JAX package's subcommands, flags and defaults, plus one top-level
``--device`` (default ``cuda``) that every command passes down, and
``check-gpu`` in place of ``check-tpu``:

    python -m facerec_torch.cli.main [--device cuda|cpu] <command> [flags]

``interactive`` (also the default with no command), ``download``,
``preprocess``, ``train`` (with ``--lr-finder``), ``evaluate``,
``predict``, ``cv``, ``hyperopt``, ``visualize``, ``compare-all``,
``list-models``, ``check-gpu``, ``demo`` (the Streamlit UI where
``streamlit`` is installed, else headless) and ``bench`` (``bench.py``'s
benchmark, ``facerec_torch.bench``) run.
Checkpoints and outputs go under ``$FACEREC_ROOT/outputs`` (default: the
repository).

``train``, ``evaluate``, ``cv`` and ``hyperopt`` first call
``parallel.mesh.initialize_distributed``: under ``torchrun`` (with
``FACEREC_COORDINATOR=auto``) or with ``FACEREC_COORDINATOR``,
``FACEREC_NUM_PROCESSES`` and ``FACEREC_PROCESS_ID`` set, every rank joins
one process group and the command runs over all of them; with none set
it runs in this process alone.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m facerec_torch.cli.main",
                                description="PyTorch/CUDA face-recognition framework")
    p.add_argument("--device", default="cuda",
                   help="torch device every command runs on (default: cuda; cpu to run "
                        "the plain PyTorch versions)")
    sub = p.add_subparsers(dest="command")

    sub.add_parser("interactive", help="interactive menu")
    sub.add_parser("demo", help="live demo (Streamlit UI, else headless on a synthetic camera)")
    sub.add_parser("check-gpu", help="report accelerator status")
    sub.add_parser("list-models", help="list model types")
    sub.add_parser("bench", help="run the end-to-end benchmark")

    d = sub.add_parser("download", help="download datasets")
    d.add_argument("--dataset", default=None, help="dataset1|dataset2|lfw (default: both main sets)")

    pre = sub.add_parser("preprocess", help="detect/align/crop raw data")
    pre.add_argument("--test", action="store_true", help="test mode: 3 persons x 10 images")
    pre.add_argument("--raw-dir", default=None)
    pre.add_argument("--out-dir", default=None)
    pre.add_argument("--config-name", default="default")
    pre.add_argument("--no-mtcnn", action="store_true")
    pre.add_argument("--max-samples", type=int, default=None)

    tr = sub.add_parser("train", help="train a model")
    tr.add_argument("--model-type", default="baseline")
    tr.add_argument("--model-name", default=None)
    tr.add_argument("--dataset", required=True, help="processed dataset dir (with train/val/test)")
    tr.add_argument("--batch-size", type=int, default=None)
    tr.add_argument("--epochs", type=int, default=None)
    tr.add_argument("--lr", type=float, default=None)
    tr.add_argument("--weight-decay", type=float, default=None)
    tr.add_argument("--image-size", type=int, default=None)
    tr.add_argument("--scheduler", default=None)
    tr.add_argument("--seed", type=int, default=42)
    tr.add_argument("--resume", action="store_true")
    tr.add_argument("--lr-finder", action="store_true")
    tr.add_argument("--arcface-margin", type=float, default=None)
    tr.add_argument("--arcface-scale", type=float, default=None)
    tr.add_argument("--arcface-easy-margin", action="store_true")
    tr.add_argument("--arcface-no-progressive", action="store_true")
    tr.add_argument("--arcface-no-two-phase", action="store_true")
    tr.add_argument("--arcface-warmup", type=int, default=None)
    tr.add_argument("--clip-grad-norm", type=float, default=None)

    ev = sub.add_parser("evaluate", help="evaluate a trained model")
    ev.add_argument("--model-type", default="baseline")
    ev.add_argument("--model-name", default=None)
    ev.add_argument("--dataset", default=None)
    ev.add_argument("--batch-size", type=int, default=64)
    ev.add_argument("--image-size", type=int, default=None)

    pr = sub.add_parser("predict", help="predict a single image")
    pr.add_argument("--model-type", default="baseline")
    pr.add_argument("--model-name", default=None)
    pr.add_argument("--image-path", required=True)
    pr.add_argument("--dataset", required=True, help="dataset dir (for class names)")

    cv = sub.add_parser("cv", help="k-fold cross validation")
    cv.add_argument("--model-type", default="baseline")
    cv.add_argument("--dataset", required=True)
    cv.add_argument("--folds", type=int, default=5)
    cv.add_argument("--epochs", type=int, default=15)
    cv.add_argument("--warm-start", default=None)

    hp = sub.add_parser("hyperopt", help="hyperparameter tuning")
    hp.add_argument("--model-type", default="baseline")
    hp.add_argument("--dataset", required=True)
    hp.add_argument("--trials", type=int, default=20)
    hp.add_argument("--epochs", type=int, default=12)
    hp.add_argument("--timeout", type=float, default=None)
    hp.add_argument("--no-trial0", action="store_true")
    hp.add_argument("--no-pruning", action="store_true")
    hp.add_argument("--storage", default=None, help="sqlite path for resumable studies")
    hp.add_argument("--study-name", default=None)
    hp.add_argument("--train-best", action="store_true")
    hp.add_argument("--lr-finder", action="store_true",
                    help="LR range-test pre-pass centers the LR search window")

    vz = sub.add_parser("visualize", help="embedding-space visualization CSVs")
    vz.add_argument("--model-type", default="siamese")
    vz.add_argument("--model-name", default=None)
    vz.add_argument("--dataset", required=True)

    ca = sub.add_parser("compare-all", help="train+evaluate every model type on one dataset")
    ca.add_argument("--dataset", required=True)
    ca.add_argument("--epochs", type=int, default=10)
    ca.add_argument("--batch-size", type=int, default=32)
    ca.add_argument("--image-size", type=int, default=None)
    return p


def _train_config_from_args(args):
    from facerec_torch.config import ArcFaceConfig, OptimizerConfig, SchedulerConfig, TrainConfig

    base = TrainConfig()
    opt = OptimizerConfig(
        learning_rate=args.lr or base.optimizer.learning_rate,
        weight_decay=args.weight_decay if args.weight_decay is not None else base.optimizer.weight_decay,
        grad_clip_norm=args.clip_grad_norm or base.optimizer.grad_clip_norm,
    )
    if args.model_type == "arcface":
        opt = opt.replace(name="adamw", amsgrad=True)
    sched = SchedulerConfig(name=args.scheduler or ("warmup_cosine" if args.model_type == "arcface" else "cosine"))
    arc = ArcFaceConfig(
        margin=args.arcface_margin if args.arcface_margin is not None else 0.5,
        scale=args.arcface_scale if args.arcface_scale is not None else 32.0,
        easy_margin=args.arcface_easy_margin,
        progressive_margin=not args.arcface_no_progressive,
        two_phase=not args.arcface_no_two_phase,
        warmup_epochs=args.arcface_warmup or 10,
    )
    return base.replace(
        model_type=args.model_type,
        model_name=args.model_name,
        batch_size=args.batch_size or base.batch_size,
        epochs=args.epochs or base.epochs,
        image_size=args.image_size or base.image_size,
        seed=args.seed,
        resume=args.resume,
        use_lr_finder=args.lr_finder,
        optimizer=opt,
        scheduler=sched,
        arcface=arc,
    )


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cmd = args.command or "interactive"
    dev = args.device

    if cmd in ("train", "evaluate", "cv", "hyperopt"):
        from facerec_torch.parallel.mesh import initialize_distributed

        initialize_distributed(device=dev)

    if cmd == "bench":
        from facerec_torch import bench

        return bench.main(device=dev)

    if cmd == "interactive":
        from facerec_torch.cli.interactive import interactive_menu

        return interactive_menu(dev)

    if cmd == "download":
        from facerec_torch.data.download import download_all_datasets, download_dataset

        if args.dataset:
            download_dataset(args.dataset)
        else:
            download_all_datasets()
        return 0

    if cmd == "preprocess":
        from facerec_torch.config import PreprocessingConfig
        from facerec_torch.data.preprocess import process_raw_data

        cfg = PreprocessingConfig(name=args.config_name, use_mtcnn=not args.no_mtcnn)
        out = process_raw_data(args.raw_dir, args.out_dir, cfg,
                               max_samples_per_class=args.max_samples, test_mode=args.test,
                               device=dev)
        print(out)
        return 0

    if cmd == "check-gpu":
        from facerec_torch.config import check_device

        print(json.dumps(check_device(dev), indent=2))
        return 0

    if cmd == "list-models":
        from facerec_torch.models import MODEL_TYPES

        for m in MODEL_TYPES:
            print(m)
        return 0

    if cmd == "train":
        from facerec_torch.train.engine import train_model

        cfg = _train_config_from_args(args)
        out = train_model(cfg, args.dataset, device=dev)
        print(json.dumps(out["summary"], indent=2, default=str))
        return 0

    if cmd == "evaluate":
        from facerec_torch.config import EvalConfig
        from facerec_torch.eval.engine import evaluate_model

        cfg = EvalConfig(model_type=args.model_type, model_name=args.model_name,
                         batch_size=args.batch_size)
        if args.image_size:
            cfg = cfg.replace(image_size=args.image_size)
        res = evaluate_model(cfg, args.dataset, device=dev)
        print(json.dumps({k: v for k, v in res.items() if isinstance(v, (int, float, str))},
                         indent=2))
        return 0

    if cmd == "predict":
        from facerec_torch.config import EvalConfig
        from facerec_torch.data.datasets import ImageFolderIndex
        from facerec_torch.eval.engine import predict_image

        names = ImageFolderIndex.build(Path(args.dataset) / "train").class_names
        cfg = EvalConfig(model_type=args.model_type, model_name=args.model_name)
        print(json.dumps(predict_image(args.image_path, cfg, names, device=dev), indent=2))
        return 0

    if cmd == "cv":
        from facerec_torch.config import TrainConfig
        from facerec_torch.train.cross_validation import run_cross_validation

        cfg = TrainConfig(model_type=args.model_type)
        res = run_cross_validation(cfg, args.dataset, n_splits=args.folds,
                                   epochs_per_fold=args.epochs, warm_start_model=args.warm_start,
                                   device=dev)
        print(json.dumps({k: v for k, v in res.items() if k != "fold_results"}, indent=2))
        return 0

    if cmd == "hyperopt":
        from facerec_torch.config import TuningConfig
        from facerec_torch.train.tuning import run_hyperparameter_tuning

        tcfg = TuningConfig(
            model_type=args.model_type, n_trials=args.trials, epochs_per_trial=args.epochs,
            timeout_seconds=args.timeout, use_trial0_baseline=not args.no_trial0,
            pruning=not args.no_pruning, storage=args.storage,
            study_name=args.study_name or f"{args.model_type}_study", train_best=args.train_best,
            use_lr_finder=args.lr_finder)
        res = run_hyperparameter_tuning(tcfg, args.dataset, device=dev)
        print(json.dumps({k: res[k] for k in ("best_value", "best_params", "n_trials")}, indent=2))
        return 0

    if cmd == "visualize":
        from facerec_torch import config as C
        from facerec_torch import resolve_device
        from facerec_torch.data.datasets import ImageFolderIndex
        from facerec_torch.eval.engine import _load_model_for_eval, discover_test_dir
        from facerec_torch.eval.visualizer import generate_visualization_report

        d = resolve_device(dev)
        test_dir = discover_test_dir(args.dataset)
        nc = ImageFolderIndex.build(test_dir).num_classes
        model = _load_model_for_eval(args.model_type, args.model_name or args.model_type, nc,
                                     C.CHECKPOINTS_DIR, d)
        print(json.dumps(generate_visualization_report(model, args.model_type, test_dir, device=d),
                         indent=2))
        return 0

    if cmd == "demo":
        from facerec_torch.serve.app import run_demo

        return run_demo(device=dev)

    if cmd == "compare-all":
        from facerec_torch.cli.compare import compare_all_models

        res = compare_all_models(args.dataset, epochs=args.epochs, batch_size=args.batch_size,
                                 image_size=args.image_size, device=dev)
        print(json.dumps(res, indent=2, default=str))
        return 0

    print(f"unknown command {cmd}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
