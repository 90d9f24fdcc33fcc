"""The paper bench twins and the online-learning example on the card, at
smoke or cut sizes: each twin's assertions hold, the kernel launches it
books equal the wrappers' counters, and what it learns or computes equals
the same call on the CPU (the plain versions), bit for bit.  The kernel
library cache follows ``launch.env``: a second build in the same
directory runs no ``nvcc``.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_bench_paper_cuda.py

The CPU runs are held against the reference benches in
``test_torch_bench_paper.py``, ``test_torch_bench_learning.py`` and
``test_torch_bench_temporal.py``.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from repro_torch.launch import (bench_accuracy, bench_circuit,
                                bench_comparison, bench_online_learning,
                                bench_system, bench_temporal, bench_timing,
                                online_learning)

KERNEL_MODULES = ("cim_popcount", "cim_matmul_packed", "cim_matmul",
                  "if_neuron", "stdp", "arbiter", "lif_step", "telemetry")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


class _Counts:
    """Every wrapper's launch counter, set to 0 on entry; ``counts`` holds
    the launches made inside the block (kernels launched at least once)."""

    def __enter__(self):
        self.mods = [importlib.import_module(f"repro_torch.kernels.{m}.ops")
                     for m in KERNEL_MODULES]
        for mod in self.mods:
            mod.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        self.counts = {}
        for mod in self.mods:
            self.counts.update({k: v for k, v in mod.launch_counts().items()
                                if v})
        return False


def _rows_but_times(rows):
    return [(r["name"], r["derived"]) for r in rows if r["us_per_call"] == 0]


@pytest.mark.cuda
def test_circuit_and_timing_on_the_card(cuda):
    cpu = bench_timing.run(device="cpu")
    with _Counts() as c:
        rec = bench_timing.run(device=cuda)
    assert c.counts == dict(rec.launches) == {"arbiter": 4}
    assert _rows_but_times(rec.rows) == _rows_but_times(cpu.rows)
    assert [r["derived"] for r in rec.rows] == [r["derived"] for r in
                                                cpu.rows]
    assert bench_circuit.run(device=cuda).rows == bench_circuit.run(
        device="cpu").rows


@pytest.mark.cuda
def test_learning_bench_on_the_card_equals_the_cpu(cuda):
    with _Counts() as c:
        rec = bench_online_learning.run(device=cuda, batch=64)
    assert c.counts == dict(rec.launches)
    assert rec.launches == {"stdp_update_keys": 8, "stdp_update_masks": 8,
                            "stdp_update_chain": 8, "stdp_epoch_masks": 9,
                            "stdp_column_epoch": 9,
                            "fused_fire_packed": 12}
    cpu = bench_online_learning.run(device="cpu", batch=64)
    for tag, planes in cpu.outputs.items():
        for plane, (bits, n) in planes.items():
            got_bits, got_n = rec.outputs[tag][plane]
            assert got_n == n, (tag, plane)
            assert torch.equal(got_bits.cpu(), bits), (tag, plane)


@pytest.mark.cuda
def test_system_on_the_card_equals_the_cpu(cuda):
    from repro_torch.launch.bench_common import Recorder

    batch = 32
    got, want = Recorder(), Recorder()
    with _Counts() as c:
        sim = bench_system._simulated_reference_sweep(got, cuda, batch)
        bench_system._measured_network_sweep(got, cuda, batch)
        bench_system._plane_speedup(got, cuda, batch)
    assert c.counts == dict(got.launches) == {"port_schedule": 20 + 64 + 4}
    assert sim == bench_system._simulated_reference_sweep(
        want, torch.device("cpu"), batch)
    bench_system._measured_network_sweep(want, torch.device("cpu"), batch)
    assert torch.equal(got.outputs["measured"]["logits"].cpu(),
                       want.outputs["measured"]["logits"])
    for g, w in zip(got.outputs["measured"]["activity"],
                    want.outputs["measured"]["activity"]):
        np.testing.assert_array_equal(g, w)
    # the sim and measured sweeps' rows (the last two rows are timed)
    assert [r["derived"] for r in got.rows[:12]] == [
        r["derived"] for r in want.rows[:12]]


@pytest.mark.cuda
def test_comparison_and_accuracy_on_the_card(cuda):
    rec = bench_comparison.run(device=cuda, n=512, steps=20)
    cpu = bench_comparison.run(device="cpu", n=512, steps=20)
    assert [r["name"] for r in rec.rows] == [r["name"] for r in cpu.rows]
    assert rec.rows[:4] == cpu.rows[:4]      # the paper and profile rows
    assert not rec.launches                  # the functional plan: no kernel
    acc = bench_accuracy.run(device=cuda, n=512, n_train=384, steps=20)
    assert acc.outputs["mismatch"] == 0


@pytest.mark.cuda
def test_temporal_smoke_on_the_card_equals_the_cpu(cuda):
    with _Counts() as c:
        rec = bench_temporal.run(device=cuda, smoke=True)
    assert c.counts == dict(rec.launches)
    # fused_vs_naive 4 calls; 2 stream T's x 4 calls; 2 encoders x 4 calls
    assert rec.launches == {"popcount_mac": 20, "temporal_scan": 20,
                            "tile_loads": 8, "request_stats": 2}
    cpu = bench_temporal.run(device="cpu", smoke=True)
    np.testing.assert_array_equal(rec.outputs["fused_vs_naive"]["logits"],
                                  cpu.outputs["fused_vs_naive"]["logits"])
    for g, w in zip(rec.rows[1:3], cpu.rows[1:3]):
        gf = dict(kv.split("=") for kv in g["derived"].split(";"))
        wf = dict(kv.split("=") for kv in w["derived"].split(";"))
        assert gf["pj_per_timestep"] == wf["pj_per_timestep"]
        assert gf["pj_per_stream"] == wf["pj_per_stream"]
    # the stream lanes' logits, loads and request stats and the encoder
    # lanes' logits, bit for bit the same plans' on the CPU
    held = bench_temporal.replay_on_cpu(rec)
    assert set(held) == {"stream_T2", "stream_T4", "encoder_rate",
                         "encoder_latency"}


@pytest.mark.cuda
def test_scan_at_the_benchs_new_shape_equals_the_loop(cuda):
    """T 32, B 256, the paper topology with random thresholds 0-11: the
    temporal plan on the card equals the per-step loop (the bench's
    full-size bit-identity check, here without its timing)."""
    from repro_torch.core import packing
    from repro_torch.core.esam import cost_model as cm
    from repro_torch.core.esam import temporal

    net = bench_temporal.rand_net(cm.PAPER_TOPOLOGY, device=cuda)
    cfg = temporal.TemporalConfig(n_steps=32, leak=0.125)
    ev = bench_temporal.event_stream(256, 32)
    words = packing.words_from_np(packing.pack_spikes_np(ev)).to(cuda)
    got = net.plan(mode="temporal", temporal=cfg)(words).logits.cpu().numpy()
    np.testing.assert_array_equal(
        got, temporal.temporal_forward_naive(net, ev, cfg))


@pytest.mark.cuda
def test_online_learning_example_on_the_card_equals_the_cpu(cuda, capsys):
    with _Counts() as c:
        acc0, res = online_learning.run(device=cuda)
    assert c.counts == {"stdp_epoch_masks": 6, "stdp_column_epoch": 6}
    want0, want = online_learning.run(device="cpu")
    assert acc0 == want0
    assert res.accuracy == want.accuracy and res.n_updates == want.n_updates
    assert torch.equal(res.network.weight_bits[0].cpu(),
                       want.network.weight_bits[0])
    capsys.readouterr()


@pytest.mark.cuda
def test_compile_cache_second_build_runs_no_nvcc(cuda, tmp_path,
                                                 monkeypatch):
    from repro_torch.kernels import _build
    from repro_torch.launch import env as env_mod

    monkeypatch.setenv(_build.CACHE_ENV, "unset")
    d = env_mod.enable_compilation_cache(str(tmp_path / "cache"))
    (first,) = _build.build_all(("arbiter",))
    assert first.build_s > 0.0 and first.path.parent == tmp_path / "cache"
    (second,) = _build.build_all(("arbiter",))
    assert second.build_s == 0.0 and second.path == first.path
    assert str(tmp_path / "cache") == d
