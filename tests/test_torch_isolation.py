"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of ``repro`` — checked in a
fresh interpreter (every module imported, then ``sys.modules`` inspected)
and statically (every import statement).  And ``chip_smoke.py`` refuses to
run without a GPU: non-zero exit, no result line."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _is_forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_files_import_no_jax_and_no_repro():
    files = _port_files()
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad = [n for n in names if _is_forbidden(n)]
            assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import repro_torch
mods = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(mods), "modules;", "forbidden:", bad)
assert not bad, bad
"""


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(root=str(ROOT))],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "forbidden: []" in out.stdout


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    """In the repo and in a directory holding only the script: exit code
    not 0 and no result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = ROOT
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env=env, cwd=cwd, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
