"""The device profiler on the card: ``DeviceProfiler`` with its default
``TorchProfiler`` backend captures the engine's rounds, kernels included.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_obs_cuda.py

One eager synchronous round of the paper network inside the window: the
exported Chrome trace holds that round's kernels (the cascade, the tile
loads and the request stats) once each, and the profiler reports no
error; a warmed round is one graph replay instead."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch.core.esam import cost_model as cm
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.obs import DeviceProfiler, Observability, TorchProfiler
from repro_torch.serve.engine import SpikeEngine, SpikeRequest

ROUND_KERNELS = ("mega_cascade_kernel", "tile_loads_kernel",
                 "request_stats_kernel")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _net(device):
    rng = np.random.default_rng(0)
    topo = cm.PAPER_TOPOLOGY
    bits = [rng.integers(0, 2, size=(k, n), dtype=np.int8)
            for k, n in zip(topo[:-1], topo[1:])]
    vth = [np.zeros((n,), np.int32) for n in topo[1:]]
    return EsamNetwork.from_numpy(bits, vth,
                                  np.zeros((topo[-1],), np.float32),
                                  device=device)


def _requests(n):
    rng = np.random.default_rng(1)
    return [SpikeRequest(spikes=(rng.random(cm.PAPER_TOPOLOGY[0]) < 0.4)
                         .astype(np.uint8)) for _ in range(n)]


def _capture(device, tmp_path, warm: bool):
    backend = TorchProfiler()
    prof = DeviceProfiler(str(tmp_path), skip_rounds=1, n_rounds=1,
                          profiler=backend)
    prof.prepare()
    eng = SpikeEngine(_net(device), max_batch=8, telemetry=True,
                      device=device, observability=Observability(
                          profile=prof))
    if warm:
        eng.warmup()
    eng.serve(_requests(24))       # three rounds: the second is captured
    assert prof.error is None and prof.captured == 1 and prof.done
    with open(backend.trace_path) as f:
        events = json.load(f)["traceEvents"]

    def names(*cats):
        return [e["name"] for e in events
                if str(e.get("cat", "")).lower() in cats]

    return names("kernel"), names("cuda_runtime", "runtime")


@pytest.mark.cuda
def test_profiler_captures_one_eager_round_of_kernels(cuda, tmp_path):
    kernels, runtime = _capture(cuda, tmp_path, warm=False)
    for name in ROUND_KERNELS:
        assert sum(name in k for k in kernels) == 1, (name, kernels)
    assert "cudaGraphLaunch" not in runtime


@pytest.mark.cuda
def test_profiler_captures_one_graph_replay_of_a_warmed_round(cuda,
                                                              tmp_path):
    _, runtime = _capture(cuda, tmp_path, warm=True)
    assert runtime.count("cudaGraphLaunch") == 1, runtime
