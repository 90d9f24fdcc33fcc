"""Runtime environment of the port, shared by the launcher, the benches and
subprocess launches: the persistent compile cache.

The port compiles its CUDA kernels with ``nvcc`` into shared libraries
(``kernels/_build.py``), cached on a hash of their sources and flags.  That
library cache is the port's persistent compile cache, the counterpart of
JAX's: ``enable_compilation_cache`` points it at a stable directory through
one environment variable, ``REPRO_TORCH_CACHE_DIR`` (``_build.CACHE_ENV``,
read by ``_build.build_dir()`` at every build), so a process restart loads
every library from disk and runs no ``nvcc``.  ``tuned_env`` gives a
subprocess the same directory.

CUDA graphs cannot persist across processes: a graph holds device pointers
and the captured kernels' launch records of the process that captured it.
``SpikeEngine.warmup`` (the launcher's ``--warmup``) captures them again at
every start; the cache spares it the compiles only.

The reference's host-platform mesh flags (``host_device_flags``,
``apply_host_devices``, the launcher's ``--host-devices``) belong with the
multi-device port (ROADMAP.md, multi-device) and are not here.

Nothing here imports torch or builds anything at import.
"""

from __future__ import annotations

import os
from typing import Optional

from repro_torch.kernels._build import CACHE_ENV

#: default on-disk location of the port's kernel library cache
DEFAULT_CACHE_DIR = os.path.join(
    os.path.expanduser("~"), ".cache", "repro-torch-kernels")


def enable_compilation_cache(cache_dir: Optional[str] = None) -> str:
    """Point the kernel library cache at ``cache_dir`` (default: the
    directory ``$REPRO_TORCH_CACHE_DIR`` already names, else
    ``DEFAULT_CACHE_DIR``) for this process and the processes it starts,
    create the directory, and return it.  Safe to call repeatedly; a
    library this process has already loaded stays loaded."""
    d = cache_dir or os.environ.get(CACHE_ENV) or DEFAULT_CACHE_DIR
    os.makedirs(d, exist_ok=True)
    os.environ[CACHE_ENV] = d
    return d


def tuned_env(cache_dir: Optional[str] = None) -> dict:
    """Environment-variable dict for a subprocess launch of the port: this
    process's environment with the kernel library cache's directory set
    (``cache_dir``, else the one already set, else ``DEFAULT_CACHE_DIR``)."""
    env = dict(os.environ)
    env[CACHE_ENV] = cache_dir or env.get(CACHE_ENV) or DEFAULT_CACHE_DIR
    return env
