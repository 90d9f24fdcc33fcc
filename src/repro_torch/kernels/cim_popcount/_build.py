"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> shared library -> ctypes).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, cached under ``build/repro_torch/``
at the repository root on a hash of the sources and flags, and loaded with
``ctypes``.  Nothing here runs at import time: this module imports on a
machine with no CUDA toolkit, and only :func:`load_library` needs one.
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

CSRC = Path(__file__).resolve().parent / "csrc"
LIB_NAME = "cim_popcount"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def build_dir() -> Path:
    """``<repo>/build/repro_torch`` (listed in ``.gitignore``)."""
    return Path(__file__).resolve().parents[4] / "build" / "repro_torch"


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    #: wall seconds of this process's build (0.0 when the cache was warm)
    build_s: float
    #: nvcc's ``-Xptxas -v`` report: registers, shared memory, spills
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


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ip = ctypes.POINTER(ctypes.c_int)
    lib.cim_mega_cascade.argtypes = [
        vp, i32, vp, vp, vp, vp, i32, ip, ip, i32, i32, i32, vp]
    lib.cim_mega_cascade.restype = i32
    lib.cim_mega_cascade_smem_bytes.argtypes = [i32, ip, ip, i32]
    lib.cim_mega_cascade_smem_bytes.restype = i64
    lib.cim_popcount_mac.argtypes = [vp, i64, vp, i64, vp, i32, i32, i32, vp]
    lib.cim_popcount_mac.restype = i32
    lib.cim_max_shared_optin.argtypes = [i32]
    lib.cim_max_shared_optin.restype = i64
    lib.cim_error_string.argtypes = [i32]
    lib.cim_error_string.restype = ctypes.c_char_p


@functools.lru_cache(maxsize=1)
def load_library() -> KernelLibrary:
    """Build (unless cached) and load the kernels; raises if nvcc fails."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    key = digest.hexdigest()[:16]
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"lib{LIB_NAME}-{key}.so"
    report = out_dir / f"lib{LIB_NAME}-{key}.ptxas.txt"
    build_s = 0.0
    if not lib_path.exists():
        tmp = out_dir / f".lib{LIB_NAME}-{key}.{os.getpid()}.so"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
            capture_output=True, text=True)
        build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n"
                f"{proc.stdout}{proc.stderr}")
        report.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)   # atomic: a reader never sees half a file
    lib = ctypes.CDLL(str(lib_path))
    _declare(lib)
    ptxas = report.read_text() if report.exists() else ""
    return KernelLibrary(lib=lib, path=lib_path, build_s=build_s, ptxas=ptxas)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = lib.cim_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
