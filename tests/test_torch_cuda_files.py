"""Where the port's card-only tests live: a guard, read from the sources.

The card's machine has no JAX, so a ``cuda``-marked test in a file that
imports ``jax`` or the JAX package ``repro`` is never collected there and
holds nothing.  Every ``cuda``-marked test of ``tests/test_torch_*.py``
must live in a ``*_cuda.py`` file, and no such file may import ``jax`` or
``repro`` (``repro_torch`` is the port).  Parsed with ``ast``; nothing is
imported."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
FILES = sorted(TESTS.glob("test_torch_*.py"))
CUDA_FILES = [p for p in FILES if p.name.endswith("_cuda.py")]
FORBIDDEN = ("jax", "repro")


def _is_cuda_mark(node: ast.expr) -> bool:
    """``pytest.mark.cuda``, called or not."""
    if isinstance(node, ast.Call):
        node = node.func
    return (isinstance(node, ast.Attribute) and node.attr == "cuda"
            and isinstance(node.value, ast.Attribute)
            and node.value.attr == "mark")


def _marks_cuda(tree: ast.Module) -> list[str]:
    """Names of the cuda-marked tests of a module: decorated functions and
    classes, and every test of a module whose ``pytestmark`` holds it."""
    names = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if any(_is_cuda_mark(d) for d in node.decorator_list):
                names.append(node.name)
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "pytestmark"
                for t in node.targets):
            marks = (node.value.elts
                     if isinstance(node.value, (ast.List, ast.Tuple))
                     else [node.value])
            if any(_is_cuda_mark(m) for m in marks):
                names.append("pytestmark")
    return names


def _imported_roots(tree: ast.Module) -> set[str]:
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_guard_sees_the_port_tests():
    assert len(FILES) > 10 and len(CUDA_FILES) >= 9
    assert "test_torch_cim_matmul_cuda.py" in {p.name for p in CUDA_FILES}


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_cuda_tests_live_in_cuda_files(path):
    marked = _marks_cuda(ast.parse(path.read_text()))
    if not path.name.endswith("_cuda.py"):
        assert not marked, (f"{path.name} holds cuda-marked tests {marked}; "
                            f"move them into a JAX-free *_cuda.py file")


@pytest.mark.parametrize("path", CUDA_FILES, ids=lambda p: p.name)
def test_cuda_files_import_no_jax(path):
    roots = _imported_roots(ast.parse(path.read_text()))
    assert not roots & set(FORBIDDEN), (
        f"{path.name} imports {sorted(roots & set(FORBIDDEN))}: the card's "
        f"machine has no JAX, so its tests would never run there")


def test_the_guard_catches_both_faults():
    """A cuda mark in a JAX-importing file and a JAX import in a cuda file,
    as source text, are both found."""
    src = ("import jax.numpy as jnp\nimport pytest\n"
           "from repro.kernels import ops\n\n"
           "@pytest.mark.cuda\n@pytest.mark.parametrize('n', [1])\n"
           "def test_x(cuda, n):\n    pass\n\n"
           "pytestmark = [pytest.mark.cuda]\n")
    tree = ast.parse(src)
    assert _marks_cuda(tree) == ["test_x", "pytestmark"]
    assert {"jax", "repro"} <= _imported_roots(tree)
    clean = ast.parse("import torch\nfrom repro_torch.kernels import ops\n")
    assert not _imported_roots(clean) & set(FORBIDDEN)
