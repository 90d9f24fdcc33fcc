"""The paper bench twins on the CPU against the reference's benches: Fig 6/7
(``launch.bench_circuit``), Table 2 (``launch.bench_timing``), Fig 8
(``launch.bench_system``), Table 3 (``launch.bench_comparison``), Sec
4.4.2 (``launch.bench_accuracy``) and the harness (``launch.bench_run``).

Rows the cost model or an exact datapath computes are held field for field
against the reference bench's rows (Fig 6/7, Table 2, ``table3_*`` paper
and reference-profile rows, ``fig8_ref_*``, ``fig8_sim_*`` and, on the
same bits and digits at a cut batch, ``fig8_measured_*``).  Timed rows and
rows of a trained BNN (whose init is within 3 ulp of the reference's, not
equal) are held by name and keys, read from the reference's source.  No
time is held: a CPU time says nothing of the card."""

from __future__ import annotations

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bench_rows import (assert_reference_rows, fields, parse_rows,
                              one_torch_thread)  # noqa: F401

from repro_torch.launch import (bench_accuracy, bench_circuit,
                                bench_comparison, bench_run, bench_system,
                                bench_timing)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _ref_rows(fn, *args) -> list[dict]:
    """Rows a reference bench function prints."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(*args)
    return parse_rows(buf.getvalue())


# ----------------------------------------------------------------------- #
# Fig 6/7 and Table 2: the cost model, field for field
# ----------------------------------------------------------------------- #
def test_circuit_rows_equal_the_reference(monkeypatch, tmp_path):
    from benchmarks import bench_circuit as ref

    monkeypatch.setenv("BENCH_CIRCUIT_OUT", str(tmp_path / "c.json"))
    want = _ref_rows(ref.run)
    rec = bench_circuit.run(device="cpu")
    assert [(r["name"], r["us_per_call"], r["derived"]) for r in rec.rows] \
        == [(r["name"], r["us_per_call"], r["derived"]) for r in want]
    assert len(rec.rows) == 10 and not rec.launches
    assert_reference_rows(rec.rows, "bench_circuit")


def test_timing_rows_equal_the_reference():
    from benchmarks import bench_timing as ref

    want = _ref_rows(ref.run)
    rec = bench_timing.run(device="cpu")
    assert [r["name"] for r in rec.rows] == [r["name"] for r in want]
    for got, ref_row in zip(rec.rows, want):
        assert got["derived"] == ref_row["derived"], got["name"]
        if got["name"].startswith("table2_"):
            assert got["us_per_call"] == ref_row["us_per_call"] == 0.0
    assert rec.rows[-1]["name"] == "arbiter_kernel_128x4"
    assert rec.rows[-1]["us_per_call"] > 0.0
    assert not rec.launches            # the CPU launches nothing
    assert_reference_rows(rec.rows, "bench_timing")


def test_timing_arbiter_lane_is_the_references():
    """The lane's requests and one arbiter cycle on them, bit for bit."""
    from repro.kernels.arbiter import ops as ref_arb
    from repro_torch.kernels.arbiter import ops as arb

    req = bench_timing.arbiter_requests("cpu")
    ref_req = jax.random.bernoulli(jax.random.PRNGKey(0), 0.4,
                                   (8, 128)).astype(jnp.int8)
    np.testing.assert_array_equal(req.numpy().astype(np.int8),
                                  np.asarray(ref_req))
    got = arb.arbiter(req, ports=4)
    want = ref_arb.arbiter(ref_req, ports=4, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_timing_books_the_arbiter_launches_on_the_card(monkeypatch):
    """On a CUDA device the twin books B8's 4 calls (``time_call``: one
    untimed and 3 timed); the recorder's booking by device, checked here
    without a card."""
    from repro_torch.launch.bench_common import Recorder

    rec = Recorder()
    rec.launched(torch.device("cuda", 0), {"arbiter": 1}, calls=4)
    rec.launched("cpu", {"arbiter": 1}, calls=4)
    assert dict(rec.launches) == {"arbiter": 4}


# ----------------------------------------------------------------------- #
# Fig 8
# ----------------------------------------------------------------------- #
def _drain_only(bits, spikes, vth, ports):
    """The drains the reference's sim sweep asserts, ``ceil(load / p)``
    a group at most, without its 20 compiled rank-schedule planes: its
    rows are a function of the loads alone (the port's sweep still
    simulates every drain on B5 and asserts it)."""
    from types import SimpleNamespace

    loads = np.asarray(spikes, np.int32).reshape(spikes.shape[0], -1,
                                                 128).sum(-1)
    return SimpleNamespace(
        cycles=np.ceil(loads / ports).max(axis=1).astype(np.int32))


@pytest.fixture(scope="module")
def system_rows():
    """The port's and the reference's Fig 8 sections at a cut batch (the
    sim loads are pinned a sample, so its rows do not depend on it)."""
    from benchmarks import bench_system as ref
    from benchmarks.common import Recorder as RefRecorder

    batch = 8
    mp = pytest.MonkeyPatch()
    mp.setattr(ref, "BATCH", batch)
    try:
        buf = io.StringIO()
        with redirect_stdout(buf):
            ref_rec = RefRecorder()
            ref._emit_sweep(ref_rec, "ref", ref.reference_activity())
            with pytest.MonkeyPatch.context() as sim:
                sim.setattr(ref.tile_mod, "simulate_tile_batch", _drain_only)
                ref._simulated_reference_sweep(ref_rec)
            ref._measured_network_sweep(ref_rec)
            ref._plane_speedup(ref_rec)
    finally:
        mp.undo()
    from repro_torch.launch.bench_common import Recorder

    dev = torch.device("cpu")
    rec = Recorder()
    bench_system._emit_sweep(rec, "ref", bench_system.reference_activity())
    sim = bench_system._simulated_reference_sweep(rec, dev, batch)
    bench_system._measured_network_sweep(rec, dev, batch)
    bench_system._plane_speedup(rec, dev, batch)
    return rec, ref_rec.entries, sim


def test_system_deterministic_rows_equal_the_reference(system_rows):
    rec, want, _ = system_rows
    assert [r["name"] for r in rec.rows] == [r["name"] for r in want]
    for got, ref_row in zip(rec.rows, want):
        if got["name"] == "plane_speedup_batch256":
            assert set(fields(got["derived"])) == set(
                fields(ref_row["derived"]))
            assert fields(got["derived"])["bit_identical"] == "True"
            continue
        # fig8_ref_*, fig8_sim_*, fig8_measured_* and port_sweep_batched
        assert got["derived"] == ref_row["derived"], got["name"]
    assert_reference_rows(rec.rows, "bench_system")


def test_system_sim_sweep_reproduces_the_headline(system_rows):
    from repro_torch.core.esam import cost_model as cm

    rec, _, (speed, eff) = system_rows
    assert abs(speed - cm.PAPER_SPEEDUP_4R) / cm.PAPER_SPEEDUP_4R < 0.05
    assert abs(eff - cm.PAPER_ENERGY_EFF_4R) / cm.PAPER_ENERGY_EFF_4R < 0.05
    assert not rec.launches


def test_system_measured_sweep_equals_the_references_network():
    """The measured sweep's network and digits are the reference's: the
    same 4-port logits and loads on the same bits."""
    from repro.core.esam.network import EsamNetwork as RefNetwork
    from repro_torch.core import prng
    from repro_torch.core.esam import cost_model as cm
    from repro_torch.data import digits

    topo, batch = cm.PAPER_TOPOLOGY, 8
    key, jkey = prng.PRNGKey(1), jax.random.PRNGKey(1)
    for i in range(len(topo) - 1):
        got = prng.bernoulli(prng.fold_in(key, i), 0.5, (topo[i], topo[i + 1]))
        want = jax.random.bernoulli(jax.random.fold_in(jkey, i), 0.5,
                                    (topo[i], topo[i + 1]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    from repro_torch.launch.bench_common import Recorder

    rec = Recorder()
    bench_system._measured_network_sweep(rec, torch.device("cpu"), batch)
    bits = [jax.random.bernoulli(jax.random.fold_in(jkey, i), 0.5,
                                 (topo[i], topo[i + 1])).astype(jnp.int8)
            for i in range(len(topo) - 1)]
    net = RefNetwork(weight_bits=bits,
                     vth=[jnp.zeros((n,), jnp.int32) for n in topo[1:]],
                     out_offset=jnp.zeros((topo[-1],), jnp.float32))
    x, _ = digits.make_spike_dataset(batch, seed=3)
    sweep = net.port_sweep(jnp.asarray(x).astype(bool), range(5))
    np.testing.assert_array_equal(
        rec.outputs["measured"]["logits"].numpy(), np.asarray(sweep[4][0]))
    want = net.measured_activity(jnp.asarray(x).astype(bool),
                                 traces=sweep[4][1])
    for g, w in zip(rec.outputs["measured"]["activity"], want):
        np.testing.assert_array_equal(g, w)


def test_system_run_holds_the_acceptance_claims(monkeypatch):
    """``run``: every claim held and named; a failed one raises (the
    floor forced above any ratio here)."""
    rec = bench_system.run(device="cpu", batch=8)
    claims = rec.outputs["claims"]
    assert set(claims) == {"sim_speedup", "sim_energy_eff",
                           "sim_equals_ref", "plane_floor"}
    assert all(held for held, _ in claims.values())
    monkeypatch.setattr(bench_system, "PLANE_FLOOR", 1e12)
    with pytest.raises(AssertionError, match="plane speedup"):
        bench_system.run(device="cpu", batch=8)


# ----------------------------------------------------------------------- #
# Table 3 and Sec 4.4.2
# ----------------------------------------------------------------------- #
class _StopAtTheFit(Exception):
    pass


def test_comparison_rows_equal_the_reference(monkeypatch):
    """The paper rows and the reference-profile row field for field, the
    reference's run stopped where its measured section draws its digits;
    the measured row (a BNN cut to 256 digits and 5 steps) by the keys the
    reference's emit for it writes."""
    import re

    from benchmarks import bench_comparison as ref
    from torch_bench_rows import ref_keys, ref_source

    def stop(*_a, **_k):
        raise _StopAtTheFit

    n, steps = 256, 5
    monkeypatch.setattr(ref.digits, "make_spike_dataset", stop)
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(_StopAtTheFit):
        ref.run()
    want = parse_rows(buf.getvalue())
    rec = bench_comparison.run(device="cpu", n=n, steps=steps)
    assert bench_comparison.PAPER_ROWS == ref.PAPER_ROWS
    assert [r["name"] for r in rec.rows] == [r["name"] for r in want] + [
        "table3_thiswork_measured"]
    for got, ref_row in zip(rec.rows, want):
        assert (got["us_per_call"], got["derived"]) == (
            ref_row["us_per_call"], ref_row["derived"]), got["name"]
    src = ref_source("bench_comparison")
    emit = src[src.index('"table3_thiswork_measured"'):]
    emit = emit[:emit.index("rec.write_json")]
    measured = fields(rec.rows[-1]["derived"])
    assert set(measured) == ref_keys(emit)
    assert re.fullmatch(r"[0-9.]+\(paper 97\.64 on MNIST\)",
                        measured["accuracy"])
    assert measured["timed"] == f"plan_functional_telemetry_{n}"
    assert len(rec.outputs["loads"][0]) == n     # fewer than 512 digits
    assert_reference_rows(rec.rows, "bench_comparison")


def test_accuracy_conversion_is_exact_at_a_cut_fit():
    rec = bench_accuracy.run(device="cpu", n=512, n_train=384, steps=20)
    (row,) = rec.rows
    assert row["name"] == "accuracy_bnn_to_snn"
    f = fields(row["derived"])
    assert f["pred_mismatches"] == "0(conversion exact iff 0)"
    assert rec.outputs["mismatch"] == 0
    assert rec.outputs["bnn_acc"] == rec.outputs["snn_acc"] > 0.5
    assert_reference_rows(rec.rows, "bench_accuracy")


# ----------------------------------------------------------------------- #
# the harness and the entry points
# ----------------------------------------------------------------------- #
def test_bench_run_order_is_the_references():
    import re

    from torch_bench_rows import ref_source

    src = ref_source("run")
    loop = src[src.index("for mod in ("):src.index("try:")]
    order = re.findall(r"bench_([a-z_]+)", loop)
    ported = [n for n in order if f"bench_{n}" not in bench_run.NOT_PORTED]
    assert [name for name, _ in bench_run.TWINS] == ported
    assert [f"bench_{n}" for n in order if n not in ported] == list(
        bench_run.NOT_PORTED)


class _Twin:
    def __init__(self, name, fail=False):
        self.__name__ = f"repro_torch.launch.bench_{name}"
        self.fail, self.calls = fail, []

    def run(self, **kw):
        self.calls.append(kw)
        if self.fail:
            raise RuntimeError("boom")


def test_bench_run_counts_failures_and_names_the_unported(monkeypatch,
                                                          capsys):
    ok, bad, smoky = _Twin("circuit"), _Twin("system", fail=True), \
        _Twin("temporal")
    monkeypatch.setattr(bench_run, "TWINS", (
        ("circuit", ok), ("system", bad), ("temporal", smoky)))
    assert bench_run.run(device="cpu", smoke=True) == 1
    err = capsys.readouterr().err
    assert "repro_torch.launch.bench_system,0.0,FAILED" in err
    assert "RuntimeError: boom" in err
    for name in ("bench_spiking_lm", "bench_roofline"):
        assert f"benchmarks.{name},0.0,NOT_PORTED" in err
    assert "§A.6" in err
    assert ok.calls == [{"device": "cpu"}]
    assert smoky.calls == [{"device": "cpu", "smoke": True}]


def test_bench_run_main_exits_1_on_a_failure(monkeypatch, capsys):
    monkeypatch.setattr(bench_run, "TWINS", (("system", _Twin("s", True)),))
    with pytest.raises(SystemExit) as exc:
        bench_run.main(["--device", "cpu"])
    assert exc.value.code == 1
    assert capsys.readouterr().out.startswith("name,us_per_call,derived")


@pytest.mark.parametrize("module", [bench_circuit, bench_timing, bench_system,
                                   bench_comparison, bench_accuracy])
def test_entry_points_need_a_gpu_by_default(monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        module.run()


def test_bench_run_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench_run, "TWINS", ())
    with pytest.raises(RuntimeError):
        bench_run.run()


def test_out_writes_json_only_when_asked(tmp_path, monkeypatch, capsys):
    import json

    monkeypatch.chdir(tmp_path)
    bench_circuit.main(["--device", "cpu"])
    assert list(tmp_path.iterdir()) == []
    rec = bench_circuit.main(["--device", "cpu", "--out",
                              str(tmp_path / "c.json")])
    with open(tmp_path / "c.json") as f:
        assert json.load(f) == {"results": rec.rows}
    assert "[bench] wrote" in capsys.readouterr().out
