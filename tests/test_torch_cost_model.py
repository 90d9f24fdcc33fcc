"""repro_torch cost model against repro's: the constants and the float64
accounting exactly; the float32 device accounting within 1e-6 relative
(float32 rounding of sums of a few hundred terms; the reference claims
~1e-7 for its own device twin) with cycle counts exact."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.esam import cost_model as ref
from repro_torch.core.esam import cost_model as cm

PAPER = (768, 256, 256, 256, 10)
TOPOLOGIES = [PAPER, (768, 256, 10), (768, 10), (256, 128, 64)]


def _loads(topo, batch, seed):
    """Random arbiter loads per tile: 0..128 spikes per 128-row group."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 129, size=(batch, cm.tile_geometry(k, n)[0]),
                         dtype=np.int32)
            for k, n in zip(topo[:-1], topo[1:])]


def test_constants_match_reference():
    """Every constant the port carries is the reference's (the TPU roofline
    constants of the reference are not carried)."""
    names = [n for n in dir(cm) if n.isupper() and n != "ALL_CELLS"]
    assert {"PAPER_TOPOLOGY", "E_READ_PORT_PJ", "REF_SPIKES_PER_GROUP",
            "E_TILE_CLOCKTREE_PJ_PER_CYCLE", "ARBITER_STAGE_NS"} <= set(names)
    for name in names:
        assert getattr(cm, name) == getattr(ref, name), name
    assert [dataclasses.asdict(c) for c in cm.ALL_CELLS] == [
        dataclasses.asdict(c) for c in ref.ALL_CELLS]


@pytest.mark.parametrize("p", range(5))
def test_cell_spec_matches_reference(p):
    assert (dataclasses.asdict(cm.cell_spec(p))
            == dataclasses.asdict(ref.cell_spec(p)))
    assert cm.cell_spec(p).ports == ref.cell_spec(p).ports
    assert cm.cell_spec(p).clock_hz == ref.cell_spec(p).clock_hz
    with pytest.raises(ValueError):
        cm.cell_spec(5)


@pytest.mark.parametrize("k,n", [(768, 256), (100, 10), (129, 300), (1, 1)])
def test_tile_geometry_matches_reference(k, n):
    assert cm.tile_geometry(k, n) == ref.tile_geometry(k, n)


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("read_ports", range(5))
def test_request_stats_match_reference(topo, read_ports):
    loads = _loads(topo, 17, read_ports + len(topo))
    want = ref.request_stats(topo, loads, read_ports)
    got = cm.request_stats(topo, loads, read_ports)
    assert got.read_ports == want.read_ports
    for field in ("cycles_per_tile", "cycles", "latency_ns", "energy_pj"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("read_ports", range(5))
def test_request_stats_device_within_tolerance(topo, read_ports):
    loads = _loads(topo, 33, 100 + read_ports + len(topo))
    host = ref.request_stats(topo, loads, read_ports)
    jdev = ref.request_stats_device(
        topo, [jnp.asarray(ld) for ld in loads], read_ports)
    got = cm.request_stats_device(
        topo, [torch.from_numpy(ld) for ld in loads], read_ports)
    assert set(got) == {"cycles_per_tile", "cycles", "latency_ns",
                        "energy_pj"}
    for key, value in got.items():
        assert value.dtype == torch.float32, key
        v = value.numpy()
        np.testing.assert_allclose(v, getattr(host, key), rtol=1e-6,
                                   atol=0, err_msg=key)
        np.testing.assert_allclose(v, np.asarray(jdev[key]), rtol=1e-6,
                                   atol=0, err_msg=key)
    # cycles are small integers: exact
    np.testing.assert_array_equal(got["cycles"].numpy(), host.cycles)
    np.testing.assert_array_equal(got["cycles_per_tile"].numpy(),
                                  host.cycles_per_tile)


def test_request_stats_device_rejects_wrong_tile_count():
    with pytest.raises(ValueError):
        cm.request_stats_device(PAPER, [torch.zeros((1, 6))], 4)
