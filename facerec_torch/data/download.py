"""Kaggle dataset downloader (counterpart of ``facerec_tpu/data/download.py``;
reference src/download_dataset.py:30-331).

Same registry and reorganization semantics: download via kagglehub (gated —
absent/offline environments get a clear error), scan recursively for person
directories, clean person names, reorganize into ``raw/<dataset>/<person>/``
with an ``info.txt`` manifest. Identity inference falls back to filename
prefixes when images are not in per-person folders (reference :94-196).
"""

from __future__ import annotations

import re
import shutil
import zipfile
from pathlib import Path

from facerec_torch.config import RAW_DATA_DIR, logger

DATASETS = {
    # reference download_dataset.py:30-41
    "dataset1": {
        "kaggle_id": "vishesh1412/celebrity-face-image-dataset",
        "description": "36 celebrities x ~49 images",
    },
    "dataset2": {
        "kaggle_id": "hereisburak/pins-face-recognition",
        "description": "18 celebrities x ~100 images",
    },
    # legacy third dataset (download_celebrity_dataset.py:28-41)
    "lfw": {
        "kaggle_id": "atulanandjha/lfwpeople",
        "description": "Labeled Faces in the Wild",
    },
}

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def clean_person_name(name: str) -> str:
    """Normalize a person-directory name (reference :43-55)."""
    name = re.sub(r"^pins_", "", name, flags=re.IGNORECASE)
    name = name.replace("_", " ").replace("-", " ").strip()
    name = re.sub(r"\s+", " ", name)
    return name.title().replace(" ", "_")


def scan_for_person_directories(root: Path) -> list[Path]:
    """Find directories that directly contain images (reference :57-92)."""
    out = []
    for d in sorted(root.rglob("*")):
        if d.is_dir() and any(f.suffix.lower() in IMG_EXTS for f in d.iterdir() if f.is_file()):
            out.append(d)
    if not out and any(f.suffix.lower() in IMG_EXTS for f in root.iterdir() if f.is_file()):
        out.append(root)
    return out


def _infer_identity(filename: str) -> str:
    """Filename-based identity fallback (reference :139-170): strip trailing
    digits/separators: 'Brad_Pitt_103.jpg' -> 'Brad_Pitt'."""
    stem = Path(filename).stem
    stem = re.sub(r"[\s_\-]*\d+$", "", stem)
    return clean_person_name(stem) if stem else "unknown"


def extract_images(src_root: Path, dest: Path) -> dict[str, int]:
    """Reorganize into dest/<person>/*.jpg (reference :94-196)."""
    person_dirs = scan_for_person_directories(src_root)
    counts: dict[str, int] = {}
    if person_dirs and person_dirs != [src_root]:
        for pd in person_dirs:
            person = clean_person_name(pd.name)
            target = dest / person
            target.mkdir(parents=True, exist_ok=True)
            for f in sorted(pd.iterdir()):
                if f.suffix.lower() in IMG_EXTS:
                    shutil.copy2(f, target / f.name)
                    counts[person] = counts.get(person, 0) + 1
    else:
        for f in sorted(src_root.rglob("*")):
            if f.is_file() and f.suffix.lower() in IMG_EXTS:
                person = _infer_identity(f.name)
                target = dest / person
                target.mkdir(parents=True, exist_ok=True)
                shutil.copy2(f, target / f.name)
                counts[person] = counts.get(person, 0) + 1
    return counts


def download_dataset(name: str, raw_dir: str | Path | None = None, force: bool = False) -> Path:
    """Download + reorganize one dataset (reference :198-296)."""
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name}; choices: {list(DATASETS)}")
    raw_dir = Path(raw_dir or RAW_DATA_DIR)
    dest = raw_dir / name
    if dest.exists() and any(dest.iterdir()) and not force:
        logger.info("%s already downloaded at %s", name, dest)
        return dest
    try:
        import kagglehub
    except ImportError as e:
        raise RuntimeError(
            "kagglehub is not installed in this environment; place data manually under "
            f"{dest}/<person>/*.jpg or use the synthetic dataset generator "
            "(facerec_torch.data.synthetic)") from e
    logger.info("downloading %s (%s)...", name, DATASETS[name]["kaggle_id"])
    path = Path(kagglehub.dataset_download(DATASETS[name]["kaggle_id"]))
    staging = path
    # zips are extracted to a temp staging area first (reference :232-260)
    zips = list(path.rglob("*.zip"))
    if zips:
        staging = dest.parent / f".{name}_staging"
        staging.mkdir(parents=True, exist_ok=True)
        for z in zips:
            with zipfile.ZipFile(z) as zf:
                zf.extractall(staging)
    dest.mkdir(parents=True, exist_ok=True)
    counts = extract_images(staging, dest)
    if staging != path:
        shutil.rmtree(staging, ignore_errors=True)
    manifest = [f"dataset: {name}", f"kaggle: {DATASETS[name]['kaggle_id']}",
                f"persons: {len(counts)}", f"images: {sum(counts.values())}", ""]
    manifest += [f"{p}: {c}" for p, c in sorted(counts.items())]
    (dest / "info.txt").write_text("\n".join(manifest))
    logger.info("%s: %d persons, %d images", name, len(counts), sum(counts.values()))
    return dest


def download_all_datasets(raw_dir: str | Path | None = None, names: list[str] | None = None) -> list[Path]:
    """reference :298-331."""
    return [download_dataset(n, raw_dir) for n in (names or ["dataset1", "dataset2"])]
