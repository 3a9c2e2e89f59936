"""Embedding-space visualizer (counterpart of ``facerec_tpu/eval/visualizer.py``).

Extracts up to ``max_samples`` embeddings with a trained model (its
``embed``, in eval mode, under ``torch.inference_mode`` on ``device``),
projects them by PCA(50) then t-SNE to 2 and 3 dimensions, and writes the
JAX package's CSVs: ``tsne_2d.csv``, ``tsne_3d.csv`` and the exp(-distance)
similarity matrix of the class centroids. PCA is numpy's SVD; t-SNE comes
from sklearn where it imports (looked up at call time, as the JAX package
does), else the PCA projection stands in for it.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Any

import numpy as np
import torch

from facerec_torch import resolve_device
from facerec_torch.config import VIZ_DIR, logger


def pca(x: np.ndarray, n_components: int) -> np.ndarray:
    x = x - x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:n_components].T


def project_embeddings(emb: np.ndarray, dims: int = 2, seed: int = 0) -> np.ndarray:
    """PCA(50) -> t-SNE(dims); falls back to PCA(dims)."""
    reduced = pca(emb, min(50, emb.shape[1], emb.shape[0] - 1))
    try:
        from sklearn.manifold import TSNE

        perplexity = max(2, min(30, (len(emb) - 1) // 3))
        return TSNE(n_components=dims, random_state=seed, perplexity=perplexity,
                    init="pca").fit_transform(reduced)
    except Exception:
        return reduced[:, :dims]


def projection_kind() -> str:
    """``"tsne"`` where sklearn's t-SNE imports, else ``"pca"``: which
    projection ``project_embeddings`` takes on this machine."""
    try:
        from sklearn.manifold import TSNE  # noqa: F401
    except Exception:
        return "pca"
    return "tsne"


class EmbeddingVisualizer:
    def __init__(self, model: torch.nn.Module, model_type: str, image_size: int = 224,
                 max_samples: int = 300, batch_size: int = 32, compute_dtype: str = "bfloat16",
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model
        self.model_type = model_type
        self.image_size = image_size
        self.max_samples = max_samples
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype

    def extract_embeddings(self, index) -> tuple[np.ndarray, np.ndarray, list[str]]:
        from facerec_torch.data.datasets import ClassificationBatcher
        from facerec_torch.train.steps import _autocast

        b = ClassificationBatcher(index, self.batch_size, self.image_size, shuffle=False)
        model = self.model.to(self.device).eval()
        embs, labels = [], []
        n = 0
        for batch in b.epoch(0):
            x = torch.from_numpy(batch["image"]).to(self.device)
            with torch.inference_mode(), _autocast(self.device, self.compute_dtype):
                e = model.embed(x).float().cpu().numpy()
            m = batch["mask"].astype(bool)
            embs.append(e[m])
            labels.append(batch["label"][m])
            n += int(m.sum())
            if n >= self.max_samples:
                break
        emb = np.concatenate(embs)[: self.max_samples]
        lab = np.concatenate(labels)[: self.max_samples]
        return emb, lab, index.class_names

    def export(self, index, out_dir: str | Path | None = None, seed: int = 0) -> dict[str, Any]:
        out = Path(out_dir or (VIZ_DIR / self.model_type))
        out.mkdir(parents=True, exist_ok=True)
        emb, lab, names = self.extract_embeddings(index)
        result = {"num_embeddings": len(emb), "out_dir": str(out)}
        for dims in (2, 3):
            proj = project_embeddings(emb, dims, seed)
            path = out / f"tsne_{dims}d.csv"
            with path.open("w", newline="") as f:
                w = csv.writer(f)
                w.writerow([f"dim{i}" for i in range(dims)] + ["label", "person"])
                for row, l in zip(proj, lab):
                    w.writerow(list(map(float, row)) + [int(l), names[int(l)]])
            result[f"tsne_{dims}d"] = str(path)
        # similarity matrix exp(-||a-b||) over the class centroids
        centroids = np.stack([emb[lab == c].mean(axis=0) for c in np.unique(lab)])
        d = np.linalg.norm(centroids[:, None] - centroids[None, :], axis=-1)
        sim = np.exp(-d)
        with (out / "similarity_matrix.csv").open("w", newline="") as f:
            w = csv.writer(f)
            present = [names[c] for c in np.unique(lab)]
            w.writerow([""] + present)
            for name, row in zip(present, sim):
                w.writerow([name] + [f"{v:.4f}" for v in row])
        result["similarity_matrix"] = str(out / "similarity_matrix.csv")
        logger.info("visualization exported to %s (%d embeddings)", out, len(emb))
        return result


def generate_visualization_report(model: torch.nn.Module, model_type: str, test_dir: str | Path,
                                  image_size: int = 224, out_dir: str | Path | None = None,
                                  compute_dtype: str = "bfloat16",
                                  device: str | torch.device | None = None) -> dict:
    """The visualizer over ``test_dir``'s images with ``model`` at
    ``compute_dtype`` (the JAX model's own dtype: bf16 as the command loads
    it) on ``device`` (default: the CUDA card). The images load at
    ``image_size`` (224 unless given, whatever the model trained at, as the
    JAX command does)."""
    from facerec_torch.data.datasets import ImageFolderIndex

    dev = resolve_device(device)
    index = ImageFolderIndex.build(test_dir)
    viz = EmbeddingVisualizer(model, model_type, image_size, compute_dtype=compute_dtype, device=dev)
    return viz.export(index, out_dir)
