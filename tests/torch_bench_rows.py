"""Shared checks of the bench twins' rows against the reference benches'
sources: every row name is one a reference ``emit`` writes (a literal, or
an f-string whose fields match), every ``derived`` key is one the
reference writes.  And ``one_torch_thread``, a module fixture that runs a
file's tests on one torch CPU thread: the suite runs in several worker
processes at once, and each torch's default pool of a thread a core
oversubscribes the machine (a bench twin's CPU run took ~60x longer so);
``time_call_once``, which a test puts in a twin's place of ``time_call``
so that each timed call runs once (no CPU time is held).
Imported by the ``test_torch_bench_*`` files and ``test_torch_env.py``
(pytest puts ``tests/`` on the path); no test lives here."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

BENCHMARKS = Path(__file__).resolve().parents[1] / "benchmarks"


def ref_source(name: str) -> str:
    return (BENCHMARKS / f"{name}.py").read_text()


def ref_keys(src: str) -> set[str]:
    """Every ``key=`` the reference's emit strings write."""
    return set(re.findall(r"([A-Za-z_0-9]+)=\{", src)) | set(
        re.findall(r"[;\"]([A-Za-z_0-9]+)=", src))


def ref_name_patterns(src: str) -> list[re.Pattern]:
    """The row names the reference's ``emit`` calls write, as patterns: an
    f-string's fields match any text."""
    names = re.findall(r"emit\(\s*f?\"([^\"]+)\"", src)
    return [re.compile(re.sub(r"\\\{[^}]*\\\}", ".+", re.escape(n)))
            for n in names]


def fields(derived: str) -> dict:
    """``k=v;...`` as a dict (parts that are not ``name=value``, such as
    ``saving>=43%:ok``, are left out)."""
    pairs = (kv.split("=", 1) for kv in derived.split(";") if "=" in kv)
    return {k: v for k, v in pairs if re.fullmatch(r"[A-Za-z_0-9]+", k)}


def assert_reference_rows(rows, bench: str) -> None:
    """Each row's name and every key of its ``derived`` are the reference
    bench's."""
    src = ref_source(bench)
    keys, patterns = ref_keys(src), ref_name_patterns(src)
    for row in rows:
        assert any(p.fullmatch(row["name"]) for p in patterns), row["name"]
        for key in fields(row["derived"]):
            assert key in keys, (row["name"], key)


def parse_rows(text: str) -> list[dict]:
    """``name,us,derived`` lines of captured stdout."""
    rows = []
    for line in text.splitlines():
        parts = line.split(",", 2)
        if len(parts) == 3 and re.fullmatch(r"-?[0-9.]+", parts[1]):
            rows.append({"name": parts[0], "us_per_call": float(parts[1]),
                         "derived": parts[2]})
    return rows


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def time_call_once(fn, *args, device=None, repeats=3, warmup=1, **kwargs):
    """``bench_common.time_call`` with one timed call and no warm-up: a
    twin's rows and outputs are the same, its CPU times are not held."""
    from repro_torch.launch.bench_common import time_call

    return time_call(fn, *args, device=device, repeats=1, warmup=0,
                     **kwargs)


#: the learning bench's topologies, by the tags of its rows
LEARNING_TAGS = ("768x10", "768x256x256x256x10")


def learning_runs(tag: str, batch: int):
    """The port's learning bench at ``batch`` samples (each timed call
    once), and the reference's two epochs (the matrix-RNG scan and the
    fused column event) on the bench's ``tag`` topology with the same
    bits, digits and key.  The bits are the reference bench's
    ``bernoulli(key, 0.5)`` draws, drawn through ``core/prng.py``
    (``jax.random.bernoulli``'s bits, ``test_torch_prng.py``), which
    spares the draws' compiles.  Returns ``(recorder, {"scan": ...,
    "fused": ...})``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.core.esam import learning as ref_learning
    from repro_torch.core import prng
    from repro_torch.data import digits
    from repro_torch.launch import bench_online_learning as bench

    with pytest.MonkeyPatch.context() as once:
        once.setattr(bench, "time_call", time_call_once)
        rec = bench.run(device="cpu", batch=batch)
    xn, yn = digits.make_spike_dataset(batch, seed=7)
    x, y = jnp.asarray(xn).astype(bool), jnp.asarray(yn)

    def draw(key, shape):
        return jnp.asarray(prng.bernoulli(key, 0.5, shape).numpy()
                           .astype(np.int8))

    never = jnp.full((10,), 2**31 - 1, jnp.int32)
    if tag == LEARNING_TAGS[0]:
        bits, vth = [draw(prng.PRNGKey(0), (768, 10))], [never]
    else:
        topo = bench.PAPER_TOPOLOGY
        bits = [draw(prng.fold_in(prng.PRNGKey(2), i),
                     (topo[i], topo[i + 1])) for i in range(len(topo) - 1)]
        vth = [jnp.zeros((n,), jnp.int32) for n in topo[1:-1]] + [never]
    key = jax.random.PRNGKey(1)
    kw = dict(p_pot=0.2, p_dep=0.1)
    return rec, {
        "scan": ref_learning.online_learning_epoch_scan(bits, vth, x, y,
                                                        key, **kw),
        "fused": ref_learning.online_learning_epoch(bits, vth, x, y, key,
                                                    **kw)}


def assert_learning_rows(rec, tag: str, epochs: dict, batch: int) -> None:
    """``tag``'s two epoch rows carry the reference's hardware cost of the
    reference's update count; the times (updates/s, the speedup) are the
    device's and not held."""
    from benchmarks import bench_online_learning as ref

    got = {r["name"]: r for r in rec.rows}
    for plane, name in (("scan", "learning_epoch_scan_"),
                        ("fused", "learning_epoch_column_event_")):
        g = fields(got[name + tag]["derived"])
        w = fields(ref._hw_cost(int(epochs[plane][1])))
        assert {k: g[k] for k in w} == w, (tag, plane)
        assert g["batch"] == str(batch)


def assert_learning_bits(rec, tag: str, epochs: dict) -> None:
    """Each plane on ``tag`` learned the reference's bits and update
    count."""
    for plane in ("scan", "fused"):
        got_bits, got_n = rec.outputs[tag][plane]
        want_bits, want_n = epochs[plane]
        np.testing.assert_array_equal(
            got_bits.numpy().astype(np.int8),
            np.asarray(want_bits).astype(np.int8), err_msg=(tag, plane))
        assert got_n == int(want_n), (tag, plane)
        assert got_n > 0
