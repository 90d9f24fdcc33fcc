"""repro_torch SpikeEngine against repro SpikeEngine on the same digit
requests, on the CPU: labels, logits and cycles bit for bit; latency and
energy within 1e-6 relative (float32 device telemetry, see
test_torch_cost_model); the identity, rounds and cost sections of
``stats()``.  Also the device rule: without a GPU, the default device
raises everywhere."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.esam.network import EsamNetwork as JaxNetwork
from repro.data import digits as jdigits
from repro.serve import engine as jengine
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.data import digits
from repro_torch.launch import serve as serve_mod
from repro_torch.serve import engine

PAPER = (768, 256, 256, 256, 10)
#: host wall times: present in both, comparable in neither
WALL_KEYS = {"host_pack_s_total", "dispatch_s_total"}


def _pair(topo, seed):
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, size=(k, n), dtype=np.int8)
            for k, n in zip(topo[:-1], topo[1:])]
    vth = [rng.integers(-4, 5, size=(n,), dtype=np.int32) for n in topo[1:]]
    off = (0.5 * rng.normal(size=(topo[-1],))).astype(np.float32)
    ref = JaxNetwork([jnp.asarray(b) for b in bits],
                     [jnp.asarray(v) for v in vth], jnp.asarray(off))
    return ref, EsamNetwork.from_numpy(bits, vth, off, device="cpu")


def _sections(schema, names=("identity", "rounds", "events", "cost")):
    return {k for name in names for k in schema[name]}


@pytest.mark.parametrize("n_requests,read_ports", [(300, 4), (77, 1)])
def test_engine_matches_reference(n_requests, read_ports):
    ref_net, net = _pair(PAPER, n_requests)
    x, _ = digits.make_spike_dataset(n_requests, seed=3)
    ref_reqs = [jengine.SpikeRequest(spikes=s) for s in x]
    reqs = [engine.SpikeRequest(spikes=s) for s in x]
    ref_eng = jengine.SpikeEngine(ref_net, max_batch=128, telemetry=True,
                                  read_ports=read_ports)
    eng = engine.SpikeEngine(net, max_batch=128, telemetry=True,
                             read_ports=read_ports, device="cpu")
    assert eng._buckets == ref_eng._buckets
    # two drains: a submit-then-serve and a serve(list)
    half = n_requests // 3
    for r in reqs[:half]:
        assert eng.submit(r).admitted
    ref_eng.submit(ref_reqs[:half])
    assert eng.queue_depth() == ref_eng.queue_depth() == half
    assert len(eng.serve()) == half
    ref_eng.serve()
    rest = reqs[half:]
    assert eng.serve(rest) is rest
    ref_eng.serve(ref_reqs[half:])

    for r, q in zip(reqs, ref_reqs):
        assert r.status == q.status == "done"
        assert r.label == q.label
        np.testing.assert_array_equal(r.logits, q.logits)
        assert r.cycles == q.cycles
        assert r.latency_ns == pytest.approx(q.latency_ns, rel=1e-6)
        assert r.energy_pj == pytest.approx(q.energy_pj, rel=1e-6)

    st, ref_st = eng.stats(), ref_eng.stats()
    assert set(st) == _sections(engine.stats_schema())
    for key in set(st) - WALL_KEYS:
        want = ref_st[key]
        if key in engine.stats_schema()["cost"]:
            assert st[key] == pytest.approx(want, rel=1e-6), key
        else:
            assert st[key] == want, key
    for key in WALL_KEYS:
        assert isinstance(st[key], float) and st[key] >= 0.0
    assert st["rounds_static"] == -(-half // 128) + -(-(n_requests - half)
                                                       // 128)


def test_empty_engine_stats_match_reference():
    ref_net, net = _pair((768, 256, 10), 1)
    st = engine.SpikeEngine(net, telemetry=True, device="cpu").stats()
    ref_st = jengine.SpikeEngine(ref_net, telemetry=True).stats()
    assert st["n_requests"] == 0
    for key in st:
        assert st[key] == ref_st[key], key


def test_stats_schema_is_the_reference_sections():
    schema, ref_schema = engine.stats_schema(), jengine.stats_schema()
    assert engine.STATS_SCHEMA_VERSION == jengine.STATS_SCHEMA_VERSION
    for name in ("identity", "rounds", "events", "cost"):
        assert schema[name] == ref_schema[name], name
    assert set(schema) == {"identity", "rounds", "events", "cost"}


@pytest.mark.parametrize("max_batch,min_bucket,dp",
                         [(128, 8, 1), (100, 8, 1), (5, 8, 1), (1, 1, 1),
                          (128, 1, 1), (256, 16, 4), (3, 8, 8)])
def test_bucket_sizes_match_reference(max_batch, min_bucket, dp):
    assert (engine._bucket_sizes(max_batch, min_bucket, dp)
            == jengine._bucket_sizes(max_batch, min_bucket, dp))


def test_digits_copy_matches_reference():
    x, y = digits.make_spike_dataset(40, seed=9)
    jx, jy = jdigits.make_spike_dataset(40, seed=9)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


def test_launcher_serves_on_cpu(capsys):
    run = serve_mod.main(["--esam", "--smoke", "--requests", "40",
                          "--device", "cpu"])
    assert run.net.topology == (768, 256, 10)
    assert len(run.requests) == 40
    assert all(r.label is not None and r.cycles > 0 for r in run.requests)
    assert run.warm_rounds == 1
    want = run.net.plan(mode="functional")(
        torch.from_numpy(run.spikes)).logits.numpy()
    np.testing.assert_array_equal(
        np.stack([r.logits for r in run.requests]), want)
    out = capsys.readouterr().out
    assert "req/s" in out and "MInf/s" in out and "pJ/Inf" in out
    with pytest.raises(SystemExit):
        serve_mod.main(["--smoke", "--device", "cpu"])   # no mode given


def test_default_device_raises_without_gpu(monkeypatch):
    """The card is the default; with no GPU every entry point raises rather
    than quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bits = [np.zeros((64, 32), np.int8), np.zeros((32, 10), np.int8)]
    vth = [np.zeros((32,), np.int32), np.zeros((10,), np.int32)]
    off = np.zeros((10,), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EsamNetwork.from_numpy(bits, vth, off)
    with pytest.raises(RuntimeError):
        EsamNetwork([torch.from_numpy(b) for b in bits],
                    [torch.from_numpy(v) for v in vth], torch.from_numpy(off))
    net = EsamNetwork.from_numpy(bits, vth, off, device="cpu")
    with pytest.raises(RuntimeError):
        engine.SpikeEngine(net)
    with pytest.raises(RuntimeError):
        serve_mod.main(["--esam", "--smoke", "--requests", "4"])


def test_engine_rejects_unsupported_devices():
    _, net = _pair((768, 256, 10), 2)
    with pytest.raises(ValueError):
        engine.SpikeEngine(net, device="meta")
