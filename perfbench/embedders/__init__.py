"""One module a served embedder kind (the configuration's
``embedder.kind``): its parameter shapes, the program's embedder built on
given weights, and the plain reference's forward pass."""

from __future__ import annotations

import importlib


def get(kind: str):
    return importlib.import_module(f"perfbench.embedders.{kind}")
