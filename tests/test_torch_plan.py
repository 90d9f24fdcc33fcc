"""repro_torch EsamPlan against repro EsamPlan on the CPU: logits, collected
planes and telemetry loads, bit for bit, for the functional and packed
modes, on networks whose parameters are made with numpy and loaded into both
packages."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.esam.network import EsamNetwork as JaxNetwork
from repro_torch.core import packing
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.core.esam.plan import PlanSpec

PAPER = (768, 256, 256, 256, 10)


def _params(topo, seed):
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, size=(k, n), dtype=np.int8)
            for k, n in zip(topo[:-1], topo[1:])]
    vth = [rng.integers(-8, 9, size=(n,), dtype=np.int32) for n in topo[1:]]
    off = rng.normal(size=(topo[-1],)).astype(np.float32)
    return bits, vth, off


def _pair(topo, seed):
    bits, vth, off = _params(topo, seed)
    ref = JaxNetwork([jnp.asarray(b) for b in bits],
                     [jnp.asarray(v) for v in vth], jnp.asarray(off))
    return ref, EsamNetwork.from_numpy(
        [np.asarray(w) for w in ref.weight_bits],
        [np.asarray(v) for v in ref.vth], np.asarray(ref.out_offset),
        device="cpu")


def _spikes(shape, seed, p=0.5):
    return np.random.default_rng(seed).random(shape) < p


def _assert_result_equal(ref_res, res):
    np.testing.assert_array_equal(res.logits.numpy(),
                                  np.asarray(ref_res.logits))
    for field in ("planes", "loads"):
        want, got = getattr(ref_res, field), getattr(res, field)
        if want is None:
            assert got is None
            continue
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            g = (packing.words_to_np(g) if w.dtype == np.uint32
                 else g.numpy())
            np.testing.assert_array_equal(g, w)


TOPOLOGIES = [PAPER, (768, 256, 10), (768, 10), (256, 128, 64)]


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("mode", ["functional", "packed"])
def test_plan_matches_reference(topo, mode):
    ref, net = _pair(topo, sum(topo))
    x = _spikes((33, topo[0]), len(topo))
    for collect, telemetry in ((False, False), (True, True)):
        want = ref.plan(mode=mode, collect=collect, telemetry=telemetry)(
            jnp.asarray(x))
        got = net.plan(mode=mode, collect=collect, telemetry=telemetry)(
            torch.from_numpy(x))
        _assert_result_equal(want, got)


@given(seed=st.integers(0, 2**16), data=st.data())
@settings(max_examples=8, deadline=None, database=None)
def test_plan_random_small_topology(seed, data):
    """Random topology: 32-aligned hidden widths (the packed plan's
    contract), any n_in and class count, either mode."""
    n_hidden = data.draw(st.integers(1, 3))
    topo = (data.draw(st.integers(1, 160)),
            *(32 * data.draw(st.integers(1, 5)) for _ in range(n_hidden)),
            data.draw(st.integers(1, 20)))
    ref, net = _pair(topo, seed)
    x = _spikes((data.draw(st.integers(1, 20)), topo[0]), seed)
    mode = data.draw(st.sampled_from(["functional", "packed"]))
    want = ref.plan(mode=mode, collect=True)(jnp.asarray(x))
    got = net.plan(mode=mode, collect=True)(torch.from_numpy(x))
    _assert_result_equal(want, got)


def test_packed_equals_functional_in_the_port():
    _, net = _pair(PAPER, 3)
    x = torch.from_numpy(_spikes((50, 768), 4))
    f = net.plan(mode="functional", telemetry=True, collect=True)(x)
    p = net.plan(mode="packed", telemetry=True, collect=True)(x)
    assert torch.equal(f.logits, p.logits)
    for a, b in zip(f.loads, p.loads):
        assert torch.equal(a, b)
    # packed planes are the network input plus the fired hidden planes
    for hidden, words in zip(f.planes, p.planes[1:]):
        assert torch.equal(packing.pack_spikes(hidden), words)


def test_plan_input_forms_and_lead_shape():
    ref, net = _pair((100, 64, 10), 5)
    x = _spikes((2, 3, 100), 6)
    want = np.asarray(ref.plan()(jnp.asarray(x)).logits)
    plan = net.plan(mode="packed")
    words_np = packing.pack_spikes_np(x)
    for inp in (torch.from_numpy(x), x.astype(np.float32), words_np,
                packing.words_from_np(words_np)):
        got = plan(inp).logits
        assert got.shape == (2, 3, 10)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        plan(torch.zeros((4, 99)))


def test_prep_cache_follows_in_place_weight_writes():
    """Buffers are mutable: an in-place write must rebuild the prepped
    operands (the reference keys on ids of immutable arrays)."""
    topo = (128, 64, 10)
    _, net = _pair(topo, 7)
    x = torch.from_numpy(_spikes((16, 128), 8))
    for mode in ("packed", "functional"):
        plan = net.plan(mode=mode)
        before = plan(x).logits.clone()
        prep = plan._prepare()
        assert plan._prepare() is prep                  # cached
        with torch.no_grad():
            net.weight_bits_1.copy_(1 - net.weight_bits_1)   # flip readout
            net.vth_0.add_(3)
        after = plan(x).logits
        fresh = EsamNetwork([w.clone() for w in net.weight_bits],
                            [v.clone() for v in net.vth],
                            net.out_offset.clone(), device="cpu")
        assert torch.equal(after, fresh.plan(mode=mode)(x).logits)
        assert not torch.equal(after, before)
        assert plan._prepare() is not prep
        with torch.no_grad():                           # restore
            net.weight_bits_1.copy_(1 - net.weight_bits_1)
            net.vth_0.sub_(3)
        assert torch.equal(plan(x).logits, before)


def test_plan_spec_rejects_unported_modes():
    for mode in ("prefix", "cycle", "temporal"):
        with pytest.raises(NotImplementedError):
            PlanSpec(mode=mode)
    with pytest.raises(ValueError):
        PlanSpec(mode="dense")
    with pytest.raises(TypeError):
        PlanSpec(read_ports=(1, 4))
    _, net = _pair((100, 60, 10), 9)
    with pytest.raises(ValueError):         # 60 hidden is not 32-aligned
        net.plan(mode="packed")
    net.plan(mode="functional")             # the dense oracle takes it


def test_network_from_reference_and_plan_cache():
    ref, net = _pair(PAPER, 11)
    assert net.topology == ref.topology
    assert net.device == torch.device("cpu")
    assert [w.dtype for w in net.weight_bits] == [torch.int8] * 4
    assert [v.dtype for v in net.vth] == [torch.int32] * 4
    assert net.out_offset.dtype == torch.float32
    assert net.plan() is net.plan(mode="packed")
    assert net.plan(telemetry=True) is not net.plan()
    assert set(dict(net.named_buffers())) == {
        *(f"weight_bits_{t}" for t in range(4)),
        *(f"vth_{t}" for t in range(4)), "out_offset"}


@pytest.mark.parametrize("allow_tf32", [True, False])
def test_functional_tile_keeps_callers_tf32_setting(allow_tf32):
    from repro_torch.core.esam.tile import functional_tile

    rng = np.random.default_rng(5)
    bits = torch.from_numpy(rng.integers(0, 2, size=(33, 7), dtype=np.int8))
    spikes = torch.from_numpy(rng.integers(0, 2, size=(4, 33), dtype=np.int8))
    vth = torch.zeros(7, dtype=torch.int32)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        _, vmem = functional_tile(bits, spikes, vth)
        assert torch.backends.cuda.matmul.allow_tf32 is allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    w = 2 * bits.numpy().astype(np.int64) - 1
    np.testing.assert_array_equal(vmem.numpy(), spikes.numpy() @ w)
