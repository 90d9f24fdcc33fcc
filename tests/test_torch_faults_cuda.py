"""repro_torch's fault plane on the CUDA kernels against the same calls on
the CPU (the plain versions), bit for bit.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_faults_cuda.py

The CPU side is held against the reference in ``test_torch_faults.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.esam.faults import FaultModel
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.core.esam.temporal import TemporalConfig

PAPER = (768, 256, 256, 256, 10)
MODELS = [
    dict(seed=5, stuck0_rate=0.08, stuck1_rate=0.06, dead_col_rate=0.1,
         vth_sigma=1.0, read_disturb=0.01, spare_cols=3),
    dict(seed=4, stuck1_rate=0.3),
    dict(seed=1, read_disturb=0.02, v_prech=0.6),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _arrays(topo, seed=0, readout_vth=None):
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, size=(k, n), dtype=np.int8)
            for k, n in zip(topo[:-1], topo[1:])]
    vth = [rng.integers(-4, 5, size=(n,)).astype(np.int32) for n in topo[1:]]
    if readout_vth is not None:
        vth[-1][:] = readout_vth
    return bits, vth, rng.normal(size=(topo[-1],)).astype(np.float32)


def _twins(topo, seed=0, **kw):
    arrays = _arrays(topo, seed, **kw)
    return (EsamNetwork.from_numpy(*arrays, device="cuda"),
            EsamNetwork.from_numpy(*arrays, device="cpu"))


def _cpu(v):
    if isinstance(v, torch.Tensor):
        return v.cpu()
    if isinstance(v, dict):
        return {k: _cpu(a) for k, a in v.items()}
    if v is None:
        return None
    return type(v)(*(_cpu(a) for a in v)) if hasattr(v, "_fields") else \
        tuple(_cpu(a) for a in v)


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if a is None:
        return b is None
    return len(a) == len(b) and all(_equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("fields", MODELS + [dict(seed=9, vth_sigma=2.5)])
def test_cuda_masks_match_cpu(cuda, fields):
    fm = FaultModel(**fields)
    got = fm.build_masks(PAPER, (1, 2, 3, 4), device=cuda)
    want = fm.build_masks(PAPER, (1, 2, 3, 4))
    assert _equal(_cpu(got), want)
    z = prng.normal(prng.PRNGKey(3, device=cuda), (4096,)).cpu()
    zc = prng.normal(prng.PRNGKey(3), (4096,))
    ulp = (z.view(torch.int32).long() - zc.view(torch.int32).long()).abs()
    assert int(ulp.max()) <= 3


@pytest.mark.cuda
@pytest.mark.parametrize("fields", MODELS)
@pytest.mark.parametrize("mode", ["functional", "packed", "prefix", "cycle",
                                  "temporal"])
def test_cuda_faulted_plans_match_cpu(cuda, mode, fields):
    gpu, cpu = _twins(PAPER, seed=1)
    fm = FaultModel(**fields)
    x = torch.from_numpy(np.random.default_rng(2).random((300, 768)) < 0.3)
    kw = dict(telemetry=True, faults=fm)
    if mode == "cycle":
        kw["read_ports"] = (0, 1, 2, 3, 4)
    elif mode != "temporal":
        kw["collect"] = True
    if mode == "temporal":
        kw["temporal"] = TemporalConfig(n_steps=3, leak=0.125)
        x = torch.stack([x, x.flip(0), x.flip(1)])
    got = gpu.plan(mode=mode, **kw)(x.cuda())
    want = cpu.plan(mode=mode, **kw)(x)
    for name in ("logits", "planes", "loads", "prefix", "traces", "sweep"):
        assert _equal(_cpu(getattr(got, name)), getattr(want, name)), name
    if mode in ("functional", "packed"):
        clean = gpu.plan(mode=mode)(x.cuda()).logits
        assert not torch.equal(got.logits, clean)


@pytest.mark.cuda
def test_cuda_faulted_engine_matches_functional_plan(cuda):
    from repro_torch.serve.engine import SpikeEngine, SpikeRequest

    gpu, cpu = _twins(PAPER, seed=3)
    fm = FaultModel(**MODELS[0])
    x = (np.random.default_rng(4).random((700, 768)) < 0.3).astype(np.uint8)
    want = gpu.plan(mode="functional", faults=fm)(
        torch.from_numpy(x).cuda()).logits.cpu().numpy()
    for kw in ({}, {"fuse_rounds": "auto", "overlap": True}):
        eng = SpikeEngine(gpu, telemetry=True, faults=fm, device="cuda", **kw)
        if kw:
            eng.warmup()
        got = eng.serve([SpikeRequest(spikes=r) for r in x])
        eng.close()
        np.testing.assert_array_equal(np.stack([r.logits for r in got]),
                                      want)
        st = eng.stats()
        assert st["faulted"] and len(st["tile_health"]) == 4
    ceng = SpikeEngine(cpu, telemetry=True, faults=fm, device="cpu")
    cgot = ceng.serve([SpikeRequest(spikes=r) for r in x])
    assert [r.cycles for r in cgot] == [r.cycles for r in got]
    assert eng.replan_degraded(1) == ((1, 1), ("data", "model"))
    again = eng.serve([SpikeRequest(spikes=r) for r in x])
    np.testing.assert_array_equal(np.stack([r.logits for r in again]), want)


@pytest.mark.cuda
def test_cuda_repair_matches_cpu(cuda):
    from repro_torch.kernels.stdp import ops as stdp_ops
    from repro_torch.train.online import train_online

    topo = (768, 256, 10)
    gpu, cpu = _twins(topo, seed=5, readout_vth=2**31 - 1)
    fm = FaultModel(seed=5, dead_col_rate=0.4, stuck1_rate=0.05)
    rng = np.random.default_rng(6)
    x = rng.random((1000, 768)) < 0.3
    y = rng.integers(0, 10, size=(1000,)).astype(np.int32)
    kw = dict(epochs=3, shuffle=True, faults=fm, key=prng.PRNGKey(10))
    stdp_ops.reset_launch_counts()
    got = train_online(gpu, x, y, **kw)
    assert stdp_ops.launch_counts()["stdp_column_epoch"] == 3
    want = train_online(cpu, x, y, **kw)
    assert got.accuracy == want.accuracy and got.n_updates == want.n_updates
    assert torch.equal(got.network.weight_bits[-1].cpu(),
                       want.network.weight_bits[-1])
