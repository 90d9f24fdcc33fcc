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
    with pytest.raises(ValueError, match="TemporalConfig"):
        PlanSpec(mode="temporal")               # ported: needs its config
    PlanSpec(mode="cycle", read_ports=(1, 4))   # ported: the port sweep
    with pytest.raises(ValueError):
        PlanSpec(mode="dense")
    with pytest.raises(TypeError):              # a sweep needs cycle mode
        PlanSpec(read_ports=(1, 4))
    _, net = _pair((100, 60, 10), 9)
    with pytest.raises(ValueError):         # 60 hidden is not 32-aligned
        net.plan(mode="packed")
    net.plan(mode="functional")             # the dense oracle takes it
    assert not net.plan(mode="prefix").prefix_packed   # the dense prefix


# ----------------------------------------------------------------------- #
# prefix mode: the learning plane's frozen hidden tiles
# ----------------------------------------------------------------------- #
#: (topology, telemetry): arbiter loads need 128-multiple tile inputs
PREFIX_CASES = [(PAPER, True), ((768, 128, 10), True), ((768, 10), True),
                ((768, 64, 10), False), ((100, 64, 96, 10), False),
                ((70, 40, 10), False), ((100, 60, 33, 7), False)]


def _assert_prefix_equal(ref_res, res):
    want = np.asarray(ref_res.prefix)
    got = (packing.words_to_np(res.prefix) if want.dtype == np.uint32
           else res.prefix.numpy())
    np.testing.assert_array_equal(got, want)
    assert res.logits is None
    for field in ("planes", "loads"):
        w_all, g_all = getattr(ref_res, field), getattr(res, field)
        if w_all is None:
            assert g_all is None
            continue
        assert len(g_all) == len(w_all)
        for g, w in zip(g_all, w_all):
            w = np.asarray(w)
            g = packing.words_to_np(g) if w.dtype == np.uint32 else g.numpy()
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("topo,telemetry_ok", PREFIX_CASES)
def test_prefix_matches_reference(topo, telemetry_ok):
    """Both branches — popcount_fire per hidden tile (32-aligned widths) and
    the dense tiles (otherwise) — with collect and telemetry on and off;
    telemetry raises in both packages where a tile input is not a multiple
    of the 128-row group."""
    ref, net = _pair(topo, sum(topo) + 1)
    x = _spikes((29, topo[0]), len(topo) + 1)
    flags = [(False, False), (True, False)]
    if telemetry_ok:
        flags += [(True, True), (False, True)]
    else:
        with pytest.raises(ValueError):
            net.plan(mode="prefix", telemetry=True)(torch.from_numpy(x))
    for collect, telemetry in flags:
        want = ref.plan(mode="prefix", collect=collect, telemetry=telemetry)(
            jnp.asarray(x))
        plan = net.plan(mode="prefix", collect=collect, telemetry=telemetry)
        got = plan(torch.from_numpy(x))
        assert plan.prefix_packed == ref.plan(mode="prefix").prefix_packed
        _assert_prefix_equal(want, got)


def test_prefix_equals_functional_hidden_in_the_port():
    """The packed prefix is the functional plan's last hidden plane."""
    _, net = _pair(PAPER, 12)
    x = torch.from_numpy(_spikes((40, 768), 13))
    f = net.plan(mode="functional", collect=True, telemetry=True)(x)
    res = net.plan(mode="prefix", collect=True, telemetry=True)(x)
    assert torch.equal(packing.unpack_spikes(res.prefix, 256, torch.bool),
                       f.planes[-1])
    for a, b in zip(res.loads, f.loads[:-1]):
        assert torch.equal(a, b)
    # words in take the same path; leading dims come back
    words = packing.pack_spikes(x).reshape(4, 10, -1)
    got = net.plan(mode="prefix")(words).prefix
    assert got.shape == (4, 10, 8)
    assert torch.equal(got.reshape(40, 8), res.prefix)


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
