"""No module of the benchmark imports JAX or the JAX package, and no module
of the plain reference imports the program. Top-level names are compared
whole: ``facerec_torch`` begins with ``facerec_t`` but is not
``facerec_tpu``."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "facerec_tpu"}
MODULES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_walk_sees_every_kind_of_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom facerec_tpu.ops import nms\n"
                 "import importlib\nimportlib.import_module('flax.linen')\n"
                 "from facerec_torch import build\n")
    assert top_level_imports(f) == {"jax", "facerec_tpu", "importlib", "flax", "facerec_torch"}


def test_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import facerec_torch.ops.gallery\nimport jaxtyping\n")
    assert not top_level_imports(f) & FORBIDDEN


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "facerec_torch" not in top_level_imports(path)
