"""The port's interactive menu (``facerec_torch/cli/interactive.py``) and
the ``preprocess`` and ``interactive`` commands against the JAX package's
on the CPU: the train wizard's configs from the same scripted answers, a
scripted menu run of each ported item that works offline at a tiny size,
and ``python -m facerec_torch.cli.main --device cpu preprocess``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import facerec_torch.cli.interactive as TI
import facerec_torch.data.preprocess as tp
import facerec_tpu.cli.interactive as JI
from facerec_torch.cli.main import main
from facerec_tpu.cli.main import main as jax_main

REPO = Path(__file__).resolve().parent.parent

# tests/test_cli.py::test_train_wizard_full_depth's answers: arcface, sgd, step
ARCFACE_STEP = ["5", "wiz", "3", "8", "", "n", "0.002", "0.0005", "4", "4", "7", "0.3", "1e-05",
                "y", "2.5", "y", "6", "0.01", "y", "0.4", "48", "n", "y", "2", "5", "0.02", "7",
                "2", "n"]
# baseline, LR finder on, plateau, no clipping, no early stopping
BASELINE_PLATEAU = ["1", "", "10", "32", "64", "y", "", "2", "3", "4", "0.25", "1e-07", "n",
                    "n", "0.2", "1", "0", "y"]
# attention, one-cycle with its max LR, adamw
ATTENTION_ONE_CYCLE = ["4", "att", "12", "16", "", "n", "0.0003", "0.01", "2", "5", "3", "0.01",
                       "1e-06", "y", "0.75", "y", "4", "0.001", "0.15", "11", "0", "n"]
# arcface, one phase, plateau, default everything else
ARCFACE_ONE_PHASE = ["5"] + [""] * 8 + ["3"] + [""] * 8 + ["n"] + [""] * 9


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scripted(monkeypatch, answers):
    it = iter(answers)

    def ask(*_):
        try:
            return next(it)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr("builtins.input", ask)
    return it


@pytest.mark.parametrize("answers", [ARCFACE_STEP, BASELINE_PLATEAU, ATTENTION_ONE_CYCLE,
                                     ARCFACE_ONE_PHASE],
                         ids=["arcface_step", "baseline_plateau", "attention_one_cycle",
                              "arcface_one_phase"])
def test_train_wizard_matches_jax(monkeypatch, answers):
    """The port's wizard builds JAX's config from the same answers, every
    field (tests/test_cli.py::test_train_wizard_full_depth)."""
    monkeypatch.setattr(JI, "_choose_dataset", lambda: "dsdir")
    monkeypatch.setattr(TI, "_choose_dataset", lambda: "dsdir")
    it = _scripted(monkeypatch, answers)
    ref, ds = JI._train_wizard()
    assert ds == "dsdir" and next(it, None) is None
    it = _scripted(monkeypatch, answers)
    got, ds = TI._train_wizard()
    assert ds == "dsdir" and next(it, None) is None
    assert got.to_dict() == ref.to_dict()


def test_train_wizard_full_depth(monkeypatch):
    """tests/test_cli.py::test_train_wizard_full_depth on the port."""
    monkeypatch.setattr(TI, "_choose_dataset", lambda: "dsdir")
    it = _scripted(monkeypatch, ARCFACE_STEP)
    cfg, ds = TI._train_wizard()
    assert ds == "dsdir"
    assert (cfg.model_type, cfg.model_name, cfg.epochs, cfg.batch_size,
            cfg.image_size, cfg.seed) == ("arcface", "wiz", 3, 8, 160, 7)
    assert cfg.optimizer.name == "sgd"
    assert cfg.optimizer.learning_rate == 0.002 and cfg.optimizer.weight_decay == 0.0005
    assert cfg.optimizer.use_grad_clip and cfg.optimizer.grad_clip_norm == 2.5
    assert cfg.scheduler.name == "step"
    assert cfg.scheduler.step_size == 7 and cfg.scheduler.gamma == 0.3
    assert cfg.scheduler.min_lr == 1e-5
    assert cfg.early_stopping and cfg.patience == 6 and cfg.min_delta == 0.01
    assert cfg.arcface.two_phase and cfg.arcface.two_phase_epoch == 2
    assert (cfg.arcface.margin, cfg.arcface.scale) == (0.4, 48.0)
    assert not cfg.arcface.easy_margin and cfg.arcface.progressive_margin
    assert cfg.arcface.warmup_epochs == 5 and cfg.arcface.label_smoothing == 0.02
    assert cfg.checkpoint_every == 2 and not cfg.resume
    assert next(it, None) is None


@pytest.mark.parametrize("answers,picked", [(["2"], "b"), (["9"], "c"), (["x"], "a"), ([], "a")])
def test_choose_matches_jax(monkeypatch, capsys, answers, picked):
    _scripted(monkeypatch, answers)
    ref = JI._choose("pick", ["a", "b", "c"])
    _scripted(monkeypatch, answers)
    assert TI._choose("pick", ["a", "b", "c"]) == ref == picked


@pytest.fixture
def raw_root(tmp_path, monkeypatch):
    """A raw tree of 1 dataset x 2 persons x 5 JPEG photos of 96 x 128, and
    the port's data directories pointed under ``tmp_path``."""
    from facerec_torch.data.synthetic import face_frames

    raw = tmp_path / "raw"
    for i, f in enumerate(face_frames(10, (96, 128), 1, np.random.default_rng(3)).astype(np.uint8)):
        d = raw / "ds0" / f"person_{i // 5}"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(f).save(d / f"{i % 5}.jpg", quality=95)
    monkeypatch.setattr(tp, "RAW_DATA_DIR", raw)
    monkeypatch.setattr(tp, "PROC_DATA_DIR", tmp_path / "processed")
    monkeypatch.setattr(tp, "WORK_SIZE", 128)
    return tmp_path


def test_menu_preprocess_on_the_cpu(raw_root, monkeypatch, capsys):
    """Menu item 1 with MTCNN on, scripted, then Exit."""
    _scripted(monkeypatch, ["1", "menu", "y", "0.4", "y", "", "n", "9"])
    assert TI.interactive_menu("cpu") == 0
    out = raw_root / "processed" / "menu"
    assert f"processed -> {out}" in capsys.readouterr().out
    stats = json.loads((out / "preprocess_stats.json").read_text())
    assert stats["datasets"]["ds0"] == {f"person_{p}": {"images": 5, "train": 3, "val": 1,
                                                        "test": 1} for p in range(2)}
    assert len(list(out.rglob("*_aug*.jpg"))) == 2 * 3 * 5
    assert json.loads((out / "config.json").read_text())["name"] == "menu"


def test_menu_exits_at_end_of_input_and_on_9(monkeypatch, capsys):
    _scripted(monkeypatch, [])
    assert TI.interactive_menu("cpu") == 0
    _scripted(monkeypatch, ["nine", "8", "9"])
    assert TI.interactive_menu("cpu") == 0
    out = capsys.readouterr().out
    assert "=== Face Recognition (cpu) ===" in out and "download is not ported" in out
    for i, o in enumerate(["Preprocess raw data", "Preprocessing visualization", "Train a model",
                           "Evaluate a model", "Hyperparameter tuning", "Cross-validation",
                           "Compare all models", "Download datasets", "Exit"]):
        assert f"  {i + 1}. {o}" in out


def test_menu_logs_a_failed_action_and_goes_on(monkeypatch, caplog, tmp_path):
    """An action that fails (here: no raw data) is logged; the menu goes on
    to the next choice, as JAX's does."""
    monkeypatch.setattr(tp, "RAW_DATA_DIR", tmp_path / "none")
    _scripted(monkeypatch, ["1", "x", "n", "", "n", "", "n", "9"])
    assert TI.interactive_menu("cpu") == 0
    assert "menu action failed" in caplog.text and "no raw datasets" in caplog.text


def test_menu_raises_a_card_error(monkeypatch):
    def cuda_error(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tp, "process_raw_data", cuda_error)
    _scripted(monkeypatch, ["1", "x", "n", "", "n", "", "n", "9"])
    with pytest.raises(RuntimeError, match="CUDA error"):
        TI.interactive_menu("cpu")


def test_default_command_is_the_menu(monkeypatch, capsys):
    _scripted(monkeypatch, ["9"])
    assert main(["--device", "cpu"]) == 0
    _scripted(monkeypatch, ["9"])
    assert main(["--device", "cpu", "interactive"]) == 0
    assert capsys.readouterr().out.count("=== Face Recognition (cpu) ===") == 2


def test_preprocess_command_matches_jax(raw_root, capsys):
    """``preprocess --no-mtcnn`` through both command lines: the same
    files, byte for byte, but the augmented ones (the port's torch
    stream), whose names match."""
    raw = raw_root / "raw"
    args = ["preprocess", "--raw-dir", str(raw), "--config-name", "c", "--no-mtcnn",
            "--max-samples", "4"]
    assert main(["--device", "cpu"] + args + ["--out-dir", str(raw_root / "port")]) == 0
    assert jax_main(args + ["--out-dir", str(raw_root / "jax")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == [str(raw_root / "port"), str(raw_root / "jax")]

    def files(root):
        return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.*"))}

    got, ref = files(raw_root / "port"), files(raw_root / "jax")
    assert sorted(got) == sorted(ref)
    assert {k: v for k, v in got.items() if "_aug" not in k} == \
        {k: v for k, v in ref.items() if "_aug" not in k}
    assert sum("_aug" in k for k in got) == 2 * 2 * 5


def test_preprocess_command_in_a_subprocess(raw_root):
    """``python -m facerec_torch.cli.main --device cpu preprocess --test
    --no-mtcnn`` (``--test``: 3 persons x 10 images at most)."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "FACEREC_ROOT": str(raw_root)}
    out = subprocess.run([sys.executable, "-m", "facerec_torch.cli.main", "--device", "cpu",
                          "preprocess", "--test", "--no-mtcnn", "--raw-dir", str(raw_root / "raw"),
                          "--out-dir", str(raw_root / "sub")],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(raw_root / "sub")
    stats = json.loads((raw_root / "sub" / "preprocess_stats.json").read_text())
    assert sorted(stats["datasets"]["ds0"]) == ["person_0", "person_1"]
    assert len(list((raw_root / "sub" / "ds0").rglob("*.jpg"))) == 10 + 2 * 3 * 5
