"""repro_torch's cycle plan on the card against its CPU twin.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs on the card's machine, where the
JAX package is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cycle_cuda.py

``plan(mode="cycle")`` at cell options 0-4 with the V_mem trace, on a
paper-topology network built from numpy draws and 48 synthetic digits:
one ``port_schedule`` launch a tile and option, every trace field and the
logits bit for bit against the same plan on the CPU.  The CPU plan is
held against the reference in ``test_torch_cycle.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.esam import cost_model as cm
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.data import digits

PAPER = cm.PAPER_TOPOLOGY


def _digit_net():
    """A CPU network of the paper topology from numpy draws, and 48 digits'
    spikes."""
    rng = np.random.default_rng(77)
    bits = [rng.integers(0, 2, size=(k, n), dtype=np.int8)
            for k, n in zip(PAPER[:-1], PAPER[1:])]
    vth = [rng.integers(-8, 9, size=(n,), dtype=np.int32) for n in PAPER[1:]]
    off = rng.normal(size=(PAPER[-1],)).astype(np.float32)
    x, _ = digits.make_spike_dataset(48, seed=3)
    return EsamNetwork.from_numpy(bits, vth, off, device="cpu"), x != 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_cycle_sweep_matches_cpu(cuda):
    from repro_torch.kernels.arbiter import ops

    net, x = _digit_net()
    bits, vth, off = net.to_numpy()
    gpu = EsamNetwork.from_numpy(bits, vth, off, device=cuda)
    ops.reset_launch_counts()
    got = gpu.plan(mode="cycle", read_ports=(0, 1, 2, 3, 4),
                   record_vmem_trace=True)(torch.from_numpy(x).to(cuda))
    assert ops.launch_counts()["port_schedule"] == 4 * (len(PAPER) - 1)
    want = net.plan(mode="cycle", read_ports=(0, 1, 2, 3, 4),
                    record_vmem_trace=True)(torch.from_numpy(x))
    for p in range(5):
        assert torch.equal(got.sweep[p]["logits"].cpu(), want.sweep[p]["logits"])
        for g, w in zip(got.sweep[p]["traces"], want.sweep[p]["traces"]):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
