"""repro_torch's round telemetry (``kernels/telemetry``) on the CPU: the
plain versions against the reference's ``_stats_jit``,
``request_stats_device`` and ``temporal_request_stats_device`` (cycles
exact; energies within 1e-6 relative: the reference's jitted float32 may
sum and divide in its own order) and the float64 numpy model, at the paper
topology, cell options 0-4, ragged B, T 1/4/16, and all-zero and all-full
loads; ``tile_loads`` against the reference's ``packing.group_popcount``;
the slab layout the engine copies out in one piece; the explicit orders
the kernel repeats (steps added one after another, the energy a step by the
float32 reciprocal of T); the wrappers' checks.  The kernels themselves are
held bit for bit against these plain versions on the card
(``tests/test_torch_serve_cuda.py``, ``chip_smoke.py``)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro.core.esam import cost_model as jcm
from repro.serve import engine as jengine
from repro_torch.core.esam import cost_model as cm
from repro_torch.kernels.telemetry import ops as tele
from repro_torch.kernels.telemetry import ref
from repro_torch.serve import engine

PAPER = cm.PAPER_TOPOLOGY
TOPOLOGIES = [PAPER, (768, 256, 10), (768, 10), (256, 128, 64)]
FILLS = ("random", "zeros", "full")


def _loads(topo, lead, seed, fill="random"):
    """Arbiter loads per tile, ``lead + (groups,)``: 0..128 spikes a group,
    or all 0, or all 128."""
    rng = np.random.default_rng(seed)
    out = []
    for k, n in zip(topo[:-1], topo[1:]):
        shape = tuple(lead) + (cm.tile_geometry(k, n)[0],)
        a = rng.integers(0, 129, size=shape, dtype=np.int32)
        if fill == "zeros":
            a[...] = 0
        elif fill == "full":
            a[...] = 128
        out.append(a)
    return out


def _close(got, want, key):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-6,
                               atol=0, err_msg=key)


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("batch", [1, 7, 128, 333])
@pytest.mark.parametrize("read_ports", range(5))
def test_request_stats_ref_matches_reference(read_ports, batch, fill):
    loads = _loads(PAPER, (batch,), 10 * batch + read_ports, fill)
    got = tele.request_stats_ref(
        PAPER, [torch.from_numpy(ld) for ld in loads], read_ports)
    jit = jengine._stats_jit(PAPER, read_ports, False)(
        [jnp.asarray(ld) for ld in loads])
    jdev = jcm.request_stats_device(
        PAPER, [jnp.asarray(ld) for ld in loads], read_ports)
    host = jcm.request_stats(PAPER, loads, read_ports)
    for key in ("cycles_per_tile", "cycles"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(jit[key]))
        np.testing.assert_array_equal(got[key].numpy(), getattr(host, key))
    for key in ("latency_ns", "energy_pj"):
        assert got[key].dtype == torch.float32
        _close(got[key].numpy(), jit[key], key)
        _close(got[key].numpy(), jdev[key], key)
        _close(got[key].numpy(), getattr(host, key), key)


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("n_steps", [1, 4, 16])
@pytest.mark.parametrize("read_ports", [0, 1, 4])
def test_temporal_request_stats_ref_matches_reference(read_ports, n_steps,
                                                      fill):
    loads = _loads(PAPER, (5, n_steps), 100 * n_steps + read_ports, fill)
    got = tele.temporal_request_stats_ref(
        PAPER, [torch.from_numpy(ld) for ld in loads], read_ports)
    jit = jengine._stats_jit(PAPER, read_ports, True)(
        [jnp.asarray(ld) for ld in loads])
    host = jcm.temporal_request_stats(PAPER, loads, read_ports)
    assert got["n_steps"] == n_steps
    for key in ("cycles_per_tile", "cycles"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(jit[key]))
        np.testing.assert_array_equal(got[key].numpy(), host[key])
    for key in ("latency_ns", "energy_pj", "energy_pj_per_step"):
        assert got[key].dtype == torch.float32
        _close(got[key].numpy(), jit[key], key)
        _close(got[key].numpy(), host[key], key)


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_request_stats_ref_other_topologies(topo):
    loads = _loads(topo, (33,), len(topo))
    got = tele.request_stats_ref(topo, [torch.from_numpy(ld) for ld in loads],
                                 2)
    host = jcm.request_stats(topo, loads, 2)
    np.testing.assert_array_equal(got["cycles"].numpy(), host.cycles)
    _close(got["energy_pj"].numpy(), host.energy_pj, "energy_pj")


def test_temporal_ref_orders_are_explicit():
    """The stream energy is its step energies added in order from 0, and
    the energy a step is that times float32(1/T): what the kernel does."""
    loads = [torch.from_numpy(ld) for ld in _loads(PAPER, (6, 9), 3)]
    got = tele.temporal_request_stats_ref(PAPER, loads, 4)
    steps = tele.request_stats_ref(
        PAPER, [ld.reshape(54, -1) for ld in loads], 4)["energy_pj"]
    steps = steps.numpy().reshape(6, 9)
    acc = np.zeros((6,), np.float32)
    for s in range(9):
        acc = (acc + steps[:, s]).astype(np.float32)
    np.testing.assert_array_equal(got["energy_pj"].numpy(), acc)
    recip = np.float32(1) / np.float32(9)
    assert tele.step_reciprocal(9) == float(recip)
    np.testing.assert_array_equal(got["energy_pj_per_step"].numpy(),
                                  (acc * recip).astype(np.float32))


def test_cost_model_device_functions_dispatch_to_the_plain_versions():
    loads = [torch.from_numpy(ld) for ld in _loads(PAPER, (17,), 5)]
    got = cm.request_stats_device(PAPER, loads, 3)
    want = tele.request_stats_ref(PAPER, loads, 3)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    tloads = [torch.from_numpy(ld) for ld in _loads(PAPER, (4, 3), 6)]
    got = cm.temporal_request_stats_device(PAPER, tloads, 1)
    want = tele.temporal_request_stats_ref(PAPER, tloads, 1)
    assert got["n_steps"] == want["n_steps"] == 3
    for key in ("cycles_per_tile", "cycles", "latency_ns", "energy_pj",
                "energy_pj_per_step"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("temporal", [False, True])
@pytest.mark.parametrize("with_logits", [False, True])
def test_request_stats_slab_layout(temporal, with_logits):
    """The CPU slab is the plain dict in ``stats_columns`` order, the logits
    first when given; ``split_stats`` reads the dict back out of it."""
    lead = (7, 4) if temporal else (7,)
    loads = [torch.from_numpy(ld) for ld in _loads(PAPER, lead, 8)]
    logits = torch.randn(7, 10) if with_logits else None
    slab = tele.request_stats(loads, PAPER, 4, temporal=temporal,
                              logits=logits)
    n_cls = 10 if with_logits else 0
    cols = tele.stats_columns(4, n_cls, temporal)
    assert slab.shape == (7, cols["width"]) and slab.dtype == torch.float32
    assert cols["width"] == n_cls + 4 + 3 + int(temporal)
    want = (tele.temporal_request_stats_ref if temporal
            else tele.request_stats_ref)(PAPER, loads, 4)
    got = tele.split_stats(slab, 4, temporal, n_cls)
    for key, value in got.items():
        assert torch.equal(value, want[key]), key
    if with_logits:
        assert torch.equal(slab[:, cols["logits"]], logits)


@pytest.mark.parametrize("lead", [(1,), (128,), (5, 64), (3, 2, 7)])
@pytest.mark.parametrize("width", [4, 8, 24])
def test_tile_loads_matches_reference_group_popcount(lead, width):
    rng = np.random.default_rng(width + sum(lead))
    words = rng.integers(0, 2 ** 32, size=lead + (width,), dtype=np.uint64
                         ).astype(np.uint32)
    planes = (torch.from_numpy(words.view(np.int32)),
              torch.full(lead + (width,), -1, dtype=torch.int32),
              torch.zeros(lead + (width,), dtype=torch.int32))
    got = tele.tile_loads(planes)
    assert len(got) == 3
    np.testing.assert_array_equal(
        got[0].numpy(), np.asarray(jpacking.group_popcount(jnp.asarray(words))))
    assert (got[1] == 128).all() and (got[2] == 0).all()
    for g in got:
        assert g.dtype == torch.int32 and g.shape == lead + (width // 4,)


def test_wrappers_reject_bad_operands():
    with pytest.raises(ValueError):
        tele.tile_loads((torch.zeros((4, 6), dtype=torch.int32),))
    with pytest.raises(TypeError):
        tele.tile_loads((torch.zeros((4, 8), dtype=torch.int64),))
    assert tele.tile_loads(()) == ()
    loads = [torch.from_numpy(ld) for ld in _loads(PAPER, (3,), 1)]
    with pytest.raises(ValueError):
        tele.request_stats(loads[:2], PAPER, 4)
    with pytest.raises(ValueError):
        cm.request_stats_device(PAPER, loads[:3], 4)


def test_stats_fn_is_shared_across_engines():
    """The counterpart of ``_stats_jit``: one cached callable per
    (topology, ports, mode), whatever engine asks."""
    fn = engine._stats_fn(PAPER, 4, False)
    assert fn is engine._stats_fn(PAPER, 4, False)
    assert fn is not engine._stats_fn(PAPER, 4, True)
    assert fn is not engine._stats_fn(PAPER, 3, False)
