"""The port's dataset downloader (``facerec_torch/data/download.py``) against
the JAX package's (``facerec_tpu/data/download.py``) on the CPU, with a stub
``kagglehub`` in ``sys.modules`` that hands back a local source tree: three
source layouts (per-person folders, a zip, flat files named by identity),
each reorganised byte for byte as JAX's with the same ``info.txt``; the
error without ``kagglehub``; the name cleaning and identity inference;
and the command line's ``download``."""

import sys
import types
import zipfile
from pathlib import Path

import numpy as np
import pytest

import facerec_torch.data.download as port
import facerec_tpu.data.download as ref
from facerec_torch.cli.main import main


def _image(path: Path, seed: int) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(np.random.default_rng(seed).bytes(64 + seed))


def _folders(src: Path) -> None:
    """Kaggle's pins layout: person folders under a wrapper directory, with
    a stray non-image file and a nested folder."""
    for i, person in enumerate(["pins_Brad Pitt", "pins_angelina-jolie", "Tom__Hanks"]):
        for j, ext in enumerate([".jpg", ".PNG", ".jpeg"]):
            _image(src / "105_classes_pins_dataset" / person / f"{person[:3]}{j}{ext}",
                   10 * i + j)
    (src / "105_classes_pins_dataset" / "README.txt").write_text("not an image")
    _image(src / "105_classes_pins_dataset" / "extra" / "deep" / "Meryl Streep" / "a.webp", 99)


def _zip(src: Path) -> None:
    staging = src.parent / "zip_src"
    _folders(staging)
    src.mkdir(parents=True)
    with zipfile.ZipFile(src / "archive.zip", "w") as zf:
        for f in sorted(staging.rglob("*")):
            if f.is_file():
                zf.write(f, f.relative_to(staging))


def _flat(src: Path) -> None:
    """Every image in one folder, the identity in the file name."""
    names = ["Brad_Pitt_103.jpg", "Brad_Pitt_7.jpg", "angelina jolie-12.png",
             "Tom-Hanks_001.bmp", "Tom-Hanks_002.bmp", "0042.jpg", "notes.txt"]
    for i, n in enumerate(names):
        _image(src / n, i)


LAYOUTS = {"folders": _folders, "zip": _zip, "flat": _flat}


def _stub_kagglehub(monkeypatch, src: Path) -> list:
    calls = []

    def dataset_download(kaggle_id):
        calls.append(kaggle_id)
        return str(src)

    monkeypatch.setitem(sys.modules, "kagglehub",
                        types.SimpleNamespace(dataset_download=dataset_download))
    return calls


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_download_matches_jax(layout, tmp_path, monkeypatch):
    src = tmp_path / "kaggle_cache"
    LAYOUTS[layout](src)
    calls = _stub_kagglehub(monkeypatch, src)
    out = {}
    for name, mod in (("port", port), ("jax", ref)):
        dest = mod.download_dataset("dataset2", raw_dir=tmp_path / name)
        assert dest == tmp_path / name / "dataset2"
        out[name] = _tree(tmp_path / name)
    assert calls == [ref.DATASETS["dataset2"]["kaggle_id"]] * 2
    assert out["port"] == out["jax"] and "dataset2/info.txt" in out["port"]
    info = out["port"]["dataset2/info.txt"].decode().splitlines()
    assert info[:2] == ["dataset: dataset2", "kaggle: hereisburak/pins-face-recognition"]
    assert not any(p.name.startswith(".") for p in (tmp_path / "port").iterdir())  # staging gone
    persons = {Path(k).parts[1] for k in out["port"] if k != "dataset2/info.txt"}
    want = {"folders": {"Brad_Pitt", "Angelina_Jolie", "Tom_Hanks", "Meryl_Streep"},
            "flat": {"Brad_Pitt", "Angelina_Jolie", "Tom_Hanks", "unknown"}}
    assert persons == want.get(layout, want["folders"])


def test_download_keeps_what_is_there(tmp_path, monkeypatch):
    calls = _stub_kagglehub(monkeypatch, tmp_path / "unused")
    _image(tmp_path / "raw" / "lfw" / "A" / "x.jpg", 1)
    assert port.download_dataset("lfw", raw_dir=tmp_path / "raw") == tmp_path / "raw" / "lfw"
    assert calls == []
    with pytest.raises(ValueError, match="unknown dataset"):
        port.download_dataset("dataset9", raw_dir=tmp_path / "raw")


def test_download_without_kagglehub(tmp_path, monkeypatch):
    """The same RuntimeError as JAX's (naming the port's synthetic
    generator), raised from the ImportError, before anything is written."""
    monkeypatch.setitem(sys.modules, "kagglehub", None)  # import raises ImportError
    errors = []
    for mod in (port, ref):
        with pytest.raises(RuntimeError, match="kagglehub is not installed") as e:
            mod.download_dataset("dataset1", raw_dir=tmp_path)
        assert isinstance(e.value.__cause__, ImportError)
        errors.append(str(e.value))
    assert errors[0] == errors[1].replace("facerec_tpu.", "facerec_torch.")
    assert not (tmp_path / "dataset1").exists()


def test_registry_and_extensions_match_jax():
    assert port.DATASETS == ref.DATASETS and port.IMG_EXTS == ref.IMG_EXTS


@pytest.mark.parametrize("name", ["pins_Brad Pitt", "PINS_tom_hanks", "angelina-jolie",
                                  "  mary   kate  ", "Jean-Luc_Picard", "o'neil", "x", "",
                                  "ÉLodie Bouchez", "a__b--c"])
def test_clean_person_name_matches_jax(name):
    assert port.clean_person_name(name) == ref.clean_person_name(name)


@pytest.mark.parametrize("filename", ["Brad_Pitt_103.jpg", "Brad Pitt 7.png", "tom-hanks-001.jpeg",
                                      "0042.jpg", "face.jpg", "pins_Zoe_Saldana12.webp",
                                      "a_1_2.jpg", "dir/Name_9.bmp"])
def test_infer_identity_matches_jax(filename):
    assert port._infer_identity(filename) == ref._infer_identity(filename)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_scan_for_person_directories_matches_jax(layout, tmp_path):
    LAYOUTS[layout](tmp_path / "src")
    assert port.scan_for_person_directories(tmp_path / "src") == \
        ref.scan_for_person_directories(tmp_path / "src")


@pytest.mark.parametrize("argv,want", [
    (["--dataset", "dataset1"], ["dataset1"]),
    (["--dataset", "dataset2"], ["dataset2"]),
    (["--dataset", "lfw"], ["lfw"]),
    ([], ["dataset1", "dataset2"]),
])
def test_cli_download(argv, want, tmp_path, monkeypatch):
    """``download`` reorganises into RAW_DATA_DIR/<dataset>: one named
    dataset, or both main ones by default, as JAX's command does."""
    src = tmp_path / "kaggle_cache"
    _folders(src)
    calls = _stub_kagglehub(monkeypatch, src)
    monkeypatch.setattr(port, "RAW_DATA_DIR", tmp_path / "raw")
    assert main(["--device", "cpu", "download"] + argv) == 0
    assert calls == [port.DATASETS[n]["kaggle_id"] for n in want]
    assert sorted(p.name for p in (tmp_path / "raw").iterdir()) == want
    for n in want:
        assert (tmp_path / "raw" / n / "info.txt").read_text().startswith(f"dataset: {n}\n")
