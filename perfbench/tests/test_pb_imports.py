"""Nothing under ``perfbench/`` imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level names are compared
whole: ``geneface_tpu_torch`` begins with ``geneface_tpu``."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "geneface_tpu"}


def _sources(sub=""):
    root = os.path.join(HERE, sub)
    for dirpath, _, files in os.walk(root):
        if ".cache" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")), ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert "geneface_tpu_torch" not in top_level_imports(path)


def test_whole_names_are_compared():
    assert "geneface_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "jax.numpy".split(".")[0] in FORBIDDEN


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types

    import run

    monkeypatch.setitem(sys.modules, "geneface_tpu", types.ModuleType("geneface_tpu"))
    assert run.forbidden_modules() == ["geneface_tpu"]
    monkeypatch.delitem(sys.modules, "geneface_tpu")
    assert "geneface_tpu" not in run.forbidden_modules()
