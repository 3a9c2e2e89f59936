"""The port's command line (``facerec_torch/cli/main.py``, ``cli/compare.py``)
against the JAX package's (``facerec_tpu/cli``) on the CPU: the parser's
surface (JAX's, plus ``--device`` and with ``check-gpu`` for ``check-tpu``),
the train config built from the same arguments, ``list-models``, smoke runs
of every ported command with ``--device cpu`` at a tiny size (outputs under
a temporary root), the unported commands' refusal (``download`` and
``bench``; ``interactive`` and ``preprocess`` run since the data side was
ported: tests/test_torch_interactive.py), the pretrained-ensemble
entry of ``compare_all_models`` and ``python -m facerec_torch.cli.main``."""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from facerec_torch.cli import compare as port_compare
from facerec_torch.cli.main import NOT_PORTED, _train_config_from_args, build_parser, main
from facerec_tpu.cli.main import _train_config_from_args as jax_train_config_from_args
from facerec_tpu.cli.main import build_parser as jax_build_parser
from facerec_tpu.cli.main import main as jax_main

REPO = Path(__file__).resolve().parent.parent
PATHS = ("CHECKPOINTS_DIR", "OUTPUTS_DIR", "VIZ_DIR")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _action(a: argparse.Action) -> tuple:
    return (tuple(a.option_strings), a.dest, repr(a.default), a.required,
            getattr(a.type, "__name__", None), type(a).__name__, a.nargs, a.const,
            tuple(a.choices) if a.choices else None)


def _surface(parser: argparse.ArgumentParser) -> dict:
    """Each subcommand's arguments (flags, dest, default, required, type,
    action), in order, and the top level's under ``""``."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    out = {"": [_action(a) for a in parser._actions
                if not isinstance(a, (argparse._SubParsersAction, argparse._HelpAction))]}
    for name, sp in sub.choices.items():
        out[name] = [_action(a) for a in sp._actions if not isinstance(a, argparse._HelpAction)]
    return out


def test_parser_surface_matches_jax():
    port, ref = _surface(build_parser()), _surface(jax_build_parser())
    assert port.pop("") == [(("--device",), "device", "'cuda'", False, None, "_StoreAction", None,
                             None, None)]
    assert ref.pop("") == []
    ref["check-gpu"] = ref.pop("check-tpu")
    assert sorted(port) == sorted(ref)
    assert list(port) == [("check-gpu" if k == "check-tpu" else k) for k in _surface(
        jax_build_parser()) if k]
    for name in port:
        assert port[name] == ref[name], name


@pytest.mark.parametrize("argv", [
    ["train", "--dataset", "d"],
    ["train", "--model-type", "arcface", "--dataset", "d", "--lr", "3e-4", "--arcface-margin",
     "0.3", "--arcface-scale", "16", "--arcface-easy-margin", "--arcface-warmup", "5",
     "--clip-grad-norm", "0.5", "--epochs", "4", "--batch-size", "8", "--image-size", "64",
     "--seed", "3", "--resume", "--lr-finder", "--model-name", "m"],
    ["train", "--model-type", "siamese", "--dataset", "d", "--weight-decay", "0", "--scheduler",
     "step", "--arcface-no-progressive", "--arcface-no-two-phase"],
])
def test_train_config_from_args_matches_jax(argv):
    got = _train_config_from_args(build_parser().parse_args(argv)).to_dict()
    assert got == jax_train_config_from_args(jax_build_parser().parse_args(argv)).to_dict()


def test_list_models_matches_jax(capsys):
    assert main(["list-models"]) == 0
    got = capsys.readouterr().out
    assert jax_main(["list-models"]) == 0
    assert got == capsys.readouterr().out
    assert got.split() == ["baseline", "cnn", "siamese", "attention", "arcface", "hybrid", "ensemble"]


def test_check_gpu_on_the_cpu(capsys):
    assert main(["--device", "cpu", "check-gpu"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["backend"] == "cpu" and info["device_count"] == 1 and info["devices"] == ["cpu"]


@pytest.mark.parametrize("argv", [["download"], ["download", "--dataset", "dataset1"],
                                  ["download", "--dataset", "dataset2"],
                                  ["download", "--dataset", "lfw"], ["bench"]])
def test_unported_commands_exit_2(argv, capsys):
    assert sorted(NOT_PORTED) == ["bench", "download"]
    assert main(["--device", "cpu"] + argv) == 2
    cmd = argv[0]
    err = capsys.readouterr().err.strip().splitlines()
    assert err == [f"facerec_torch: '{cmd}' is not ported: {NOT_PORTED[cmd]} (ROADMAP.md section 1)"]


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    """A root for the commands' checkpoints and outputs: the path constants
    of every loaded port module point under it for this module's tests."""
    import facerec_torch.cli.compare  # noqa: F401
    import facerec_torch.eval.engine  # noqa: F401
    import facerec_torch.eval.visualizer  # noqa: F401
    import facerec_torch.train.cross_validation  # noqa: F401
    import facerec_torch.train.engine  # noqa: F401

    root = tmp_path_factory.mktemp("cli_root")
    paths = {"CHECKPOINTS_DIR": root / "outputs" / "checkpoints", "OUTPUTS_DIR": root / "outputs",
             "VIZ_DIR": root / "outputs" / "visualizations"}
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in list(sys.modules.items()):
            if name.startswith("facerec_torch") and mod is not None:
                for key in PATHS:
                    if hasattr(mod, key):
                        mp.setattr(mod, key, paths[key])
        yield root


def _run(argv, capsys) -> dict | list | str:
    assert main(["--device", "cpu"] + argv) == 0
    out = capsys.readouterr().out
    try:
        return json.loads(out)
    except json.JSONDecodeError:
        return out


@pytest.fixture(scope="module")
def trained(cli_root, synthetic_imagefolder):
    """``train`` of a 32-px baseline for one epoch, as ``cli_t``."""
    assert main(["--device", "cpu", "train", "--model-type", "baseline", "--dataset",
                 str(synthetic_imagefolder), "--epochs", "1", "--batch-size", "8", "--image-size",
                 "32", "--model-name", "cli_t"]) == 0
    return cli_root / "outputs" / "checkpoints" / "cli_t"


def test_cli_train(trained):
    info = json.loads((trained / "model_info.json").read_text())
    assert info["model_type"] == "baseline" and info["epochs_trained"] == 1
    assert info["config"]["image_size"] == 32 and not info["config"]["use_lr_finder"]


def test_cli_train_lr_finder(cli_root, synthetic_imagefolder, capsys):
    out = _run(["train", "--dataset", str(synthetic_imagefolder), "--epochs", "1", "--batch-size",
                "8", "--image-size", "32", "--model-name", "cli_lrf", "--lr-finder"], capsys)
    assert out["config"]["use_lr_finder"]
    analysis = json.loads((cli_root / "outputs" / "checkpoints" / "cli_lrf" / "metrics" /
                           "lr_finder.json").read_text())
    assert analysis["valid"] and 0 < analysis["suggested_lr"] <= 1e-2


def test_cli_evaluate(trained, synthetic_imagefolder, capsys):
    out = _run(["evaluate", "--model-name", "cli_t", "--dataset", str(synthetic_imagefolder),
                "--image-size", "32"], capsys)
    assert 0.0 <= out["accuracy"] <= 1.0 and out["model_name"] == "cli_t"
    assert (trained.parent.parent / "cli_t" / "baseline_results.json").exists()


def test_cli_predict(trained, synthetic_imagefolder, capsys):
    image = sorted((synthetic_imagefolder / "test").rglob("*.jpg"))[0]
    out = _run(["predict", "--model-name", "cli_t", "--image-path", str(image), "--dataset",
                str(synthetic_imagefolder)], capsys)
    names = sorted(p.name for p in (synthetic_imagefolder / "train").iterdir())
    assert out["predicted_class"] in names and len(out["top3"]) == 3


def test_cli_visualize(trained, cli_root, synthetic_imagefolder, capsys):
    out = _run(["visualize", "--model-type", "baseline", "--model-name", "cli_t", "--dataset",
                str(synthetic_imagefolder)], capsys)
    assert out["num_embeddings"] == len(list((synthetic_imagefolder / "test").rglob("*.jpg")))
    assert Path(out["out_dir"]) == cli_root / "outputs" / "visualizations" / "baseline"
    assert Path(out["similarity_matrix"]).exists()


def test_cli_cv(cli_root, synthetic_imagefolder, capsys):
    out = _run(["cv", "--dataset", str(synthetic_imagefolder), "--folds", "2", "--epochs", "1"],
               capsys)
    assert out["n_splits"] == 2 and 0.0 <= out["mean_val_acc"] <= 1.0
    assert "fold_results" not in out
    assert list((cli_root / "outputs" / "checkpoints").glob("cv_baseline_*/cv_results.json"))


def test_cli_hyperopt(cli_root, synthetic_imagefolder, capsys):
    storage = cli_root / "study.sqlite"
    out = _run(["hyperopt", "--dataset", str(synthetic_imagefolder), "--trials", "2", "--epochs",
                "1", "--no-pruning", "--storage", str(storage)], capsys)
    assert out["n_trials"] == 2 and set(out) == {"best_value", "best_params", "n_trials"}
    assert storage.exists()
    (summary,) = list((cli_root / "outputs" / "hyperopt").glob("baseline_*/results.json"))
    assert [t["state"] for t in json.loads(summary.read_text())["trials"]] == ["COMPLETE"] * 2


def test_cli_compare_all(cli_root, synthetic_imagefolder, capsys):
    """All seven types at 32 px for one epoch; the ensemble from the
    members this run trained."""
    out = _run(["compare-all", "--dataset", str(synthetic_imagefolder), "--epochs", "1",
                "--batch-size", "8", "--image-size", "32"], capsys)
    table, _, body = out.partition("\n{") if isinstance(out, str) else ("", "", "")
    res = json.loads("{" + body)
    assert list(res) == ["baseline", "cnn", "siamese", "attention", "arcface", "hybrid", "ensemble"]
    assert all("error" not in r for r in res.values()), res
    assert table.startswith("model") and "ensemble" in table
    assert (cli_root / "outputs" / "checkpoints" / "ensemble_compare" / "best").exists()


def test_compare_all_pretrained_ensemble(synthetic_imagefolder, tmp_path):
    """As JAX's test of the same name: with one member the ensemble is that
    member, so its test accuracy is the member's exactly."""
    res = port_compare.compare_all_models(
        synthetic_imagefolder, epochs=2, batch_size=8, image_size=32,
        model_types=["baseline", "ensemble"], ensemble_members=["baseline"],
        checkpoints_root=tmp_path / "ck", outputs_root=tmp_path / "out", device="cpu")
    assert "error" not in res["ensemble"], res["ensemble"]
    assert res["ensemble"]["test_acc"] == res["baseline"]["test_acc"]
    meta = json.loads((tmp_path / "ck" / "ensemble_compare" / "best" / "metadata.json").read_text())
    assert meta["pretrained_members"]


def test_cli_demo_passes_the_device(monkeypatch):
    """``demo`` runs the headless demo on ``--device`` (its 480 x 640
    pipeline is driven on the card by chip_smoke.py's demo phase)."""
    import facerec_torch.serve.app as app

    seen = []
    monkeypatch.setattr(app, "run_demo", lambda device=None: seen.append(device) or 0)
    assert main(["--device", "cpu", "demo"]) == 0 and seen == ["cpu"]


def test_module_entry_point(tmp_path):
    """``python -m facerec_torch.cli.main`` as a user runs it."""
    out = subprocess.run([sys.executable, "-m", "facerec_torch.cli.main", "--device", "cpu",
                          "list-models"], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, FACEREC_ROOT=str(tmp_path)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "baseline" and len(out.stdout.split()) == 7
