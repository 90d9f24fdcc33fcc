"""repro_torch.core.esam.learning's epochs on the CUDA kernels against
the same epochs on the CPU (the plain versions), bit for bit.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_learning_cuda.py

The CPU epochs are held against the reference in ``test_torch_learning.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.esam import learning


def _net(topo, seed, *, tied=False):
    """numpy bits/vth (hidden vth small ints, readout never fires)."""
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, size=(k, n), dtype=np.int8)
            for k, n in zip(topo[:-1], topo[1:])]
    if tied:   # identical readout columns: every V_mem ties
        bits[-1][:] = bits[-1][:, :1]
    vth = [rng.integers(-4, 5, size=(n,), dtype=np.int32) for n in topo[1:-1]]
    vth.append(np.full((topo[-1],), 2**31 - 1, np.int32))
    return bits, vth


def _data(seed, batch, n_in, n_cls, density=0.4):
    rng = np.random.default_rng(seed)
    x = rng.random((batch, n_in)) < density
    y = rng.integers(0, n_cls, size=(batch,)).astype(np.int32)
    return x, y


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("topo", [(768, 256, 256, 256, 10), (70, 40, 10)])
def test_cuda_epochs_match_cpu(cuda, topo):
    from repro_torch.kernels.cim_matmul_packed import ops as packed_ops
    from repro_torch.kernels.stdp import ops as stdp_ops

    bits, vth = _net(topo, 17, tied=True)
    x, y = _data(18, 300, topo[0], topo[-1])
    out = {}
    for dev in ("cpu", cuda):
        stdp_ops.reset_launch_counts()
        packed_ops.reset_launch_counts()
        b, n = learning.online_learning_epoch(
            [t.to(dev) for t in _t(bits)], [t.to(dev) for t in _t(vth)],
            x, y, prng.PRNGKey(3), p_pot=0.2, p_dep=0.1)
        s, ns = learning.online_learning_epoch_scan(
            [t.to(dev) for t in _t(bits)], [t.to(dev) for t in _t(vth)],
            x[:20], y[:20], prng.PRNGKey(3), p_pot=0.2, p_dep=0.1)
        out[str(dev)] = (b.cpu(), int(n), s.cpu(), int(ns),
                         stdp_ops.launch_counts(),
                         packed_ops.launch_counts())
    cpu, gpu = out["cpu"], out[str(cuda)]
    assert torch.equal(cpu[0], gpu[0]) and cpu[1] == gpu[1]
    assert torch.equal(cpu[2], gpu[2]) and cpu[3] == gpu[3]
    # the epoch is two launches, the draw inside the first, and the
    # matrix-RNG scan three; no per-sample events or stdp_update
    assert gpu[4] == {"stdp_epoch_masks": 1, "stdp_column_epoch": 1,
                      "stdp_column_event": 0, "stdp_update": 0,
                      "stdp_update_keys": 1, "stdp_update_masks": 1,
                      "stdp_update_chain": 1}
    hidden_packed = all(n % 32 == 0 for n in topo[1:-1])
    assert gpu[5] == {"fused_fire_packed":
                      len(topo) - 2 if hidden_packed else 0,
                      "cim_matmul_packed": 0}
