"""Build and load the CUDA kernels of ``kernels/<name>/csrc`` (nvcc -> shared
library -> ctypes).

Each kernel library (``LIBRARIES``) is the ``*.cu`` sources of one kernel
package, compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface, cached under ``build/repro_torch/`` at the repository
root (or in the directory ``$REPRO_TORCH_CACHE_DIR`` names, the port's
persistent compile cache: ``launch/env.py``) on a hash of the sources, the
headers it may include (its own ``csrc/*.cuh`` and the shared
``kernels/csrc/*.cuh``, passed with ``-I``) and the flags, and loaded with
``ctypes``.  Every
library exports ``<name>_error_string(int)`` for :func:`check`.

Nothing here runs at import time: this module imports on a machine with no
CUDA toolkit, and only :func:`build_all` / :func:`load_library` need one.
:func:`build_all` starts one ``nvcc`` per library, all at once, and waits
for them; :func:`load_library` builds a missing library on its own.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

KERNELS = Path(__file__).resolve().parent
#: headers shared by several libraries (the b1 tensor-core tile helpers)
SHARED_INCLUDE = KERNELS / "csrc"
#: the kernel packages that carry CUDA sources under ``csrc/``
LIBRARIES = ("cim_popcount", "cim_matmul_packed", "stdp", "arbiter",
             "lif_step", "cim_matmul", "if_neuron", "telemetry")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


#: names the kernel library cache's directory when set (``launch/env.py``
#: sets it), as ``JAX_COMPILATION_CACHE_DIR`` names the reference's cache
CACHE_ENV = "REPRO_TORCH_CACHE_DIR"


def build_dir() -> Path:
    """``$REPRO_TORCH_CACHE_DIR`` when set, else ``<repo>/build/repro_torch``
    (listed in ``.gitignore``)."""
    cache = os.environ.get(CACHE_ENV)
    if cache:
        return Path(cache)
    return KERNELS.parents[2] / "build" / "repro_torch"


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    name: str
    lib: ctypes.CDLL
    path: Path
    #: nvcc's ``-Xptxas -v`` report: registers, shared memory, spills
    ptxas: str


@dataclasses.dataclass(frozen=True)
class BuildReport:
    name: str
    path: Path
    #: wall seconds of this process's nvcc run (0.0 when the cache was warm)
    build_s: float
    ptxas: str


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); it is needed "
            "to build the CUDA kernels of repro_torch")
    return found


def _sources(name: str) -> list[Path]:
    if name not in LIBRARIES:
        raise ValueError(f"unknown kernel library {name!r} (one of {LIBRARIES})")
    sources = sorted((KERNELS / name / "csrc").glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under kernels/{name}/csrc")
    return sources


def _paths(name: str) -> tuple[Path, Path]:
    """(library path, ptxas report path), keyed on the sources and flags."""
    csrc = KERNELS / name / "csrc"
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (_sources(name) + sorted(csrc.glob("*.cuh"))
                 + sorted(SHARED_INCLUDE.glob("*.cuh"))):
        digest.update(f"{path.parent.parent.name}/{path.name}".encode())
        digest.update(path.read_bytes())
    key = digest.hexdigest()[:16]
    out = build_dir()
    return out / f"lib{name}-{key}.so", out / f"lib{name}-{key}.ptxas.txt"


def build_all(names=LIBRARIES) -> list[BuildReport]:
    """Build every missing library, one ``nvcc`` each, all started together;
    raises with the compiler's output if any of them fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        lib_path, report = _paths(name)
        if lib_path.exists():
            running.append((name, lib_path, report, None, None, 0.0))
            continue
        tmp = out_dir / f".{lib_path.name}.{os.getpid()}"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, f"-I{SHARED_INCLUDE}", "-o", str(tmp),
             *map(str, _sources(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, lib_path, report, tmp, proc, time.perf_counter()))
    reports, failures = [], []
    for name, lib_path, report, tmp, proc, t0 in running:
        build_s = 0.0
        if proc is not None:
            text, _ = proc.communicate()
            build_s = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"nvcc failed on {name} with exit code "
                                f"{proc.returncode}:\n{text}")
                continue
            report.write_text(text)
            os.replace(tmp, lib_path)   # atomic: a reader never sees half a file
        reports.append(BuildReport(
            name=name, path=lib_path, build_s=build_s,
            ptxas=report.read_text() if report.exists() else ""))
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


@functools.lru_cache(maxsize=None)
def load_library(name: str,
                 declare: Optional[Callable[[ctypes.CDLL], None]] = None
                 ) -> KernelLibrary:
    """Build (unless cached) and load one library; ``declare`` sets the
    argument and result types of its C functions."""
    (rep,) = build_all((name,))
    lib = ctypes.CDLL(str(rep.path))
    err_fn = getattr(lib, f"{name}_error_string")
    err_fn.argtypes = [ctypes.c_int]
    err_fn.restype = ctypes.c_char_p
    if declare is not None:
        declare(lib)
    return KernelLibrary(name=name, lib=lib, path=rep.path, ptxas=rep.ptxas)


def check(kl: KernelLibrary, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = getattr(kl.lib, f"{kl.name}_error_string")(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
