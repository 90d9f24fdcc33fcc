"""repro_torch.launch.bench_serving on the CPU: the rows the reference's
``benchmarks/bench_serving.py`` emits with one device, their keys, and the
reference's paper network bit for bit.

The bench runs in-process with ``--device cpu --smoke`` and a cut
single-device lane (``--requests 256``); every row name and every key of
its ``derived`` string is one the reference's bench writes (read from its
source).  Times on the CPU say nothing of the card, so no time is held
here; the chaos lane's ``lost == 0`` raises inside the bench."""

from __future__ import annotations

import json
import re
from pathlib import Path

import jax
import numpy as np
import torch

from repro_torch.launch import bench_serving

REF = Path(__file__).resolve().parents[1] / "benchmarks" / "bench_serving.py"

#: the rows of the reference's bench on one device, in its order
ROWS = ("serving_single_device", "serving_sharded_skipped",
        "serving_cold_start", "serving_obs_overhead",
        "serving_openloop_under", "serving_openloop_over", "serving_chaos")


def _ref_keys(src: str) -> set[str]:
    """Every ``key=`` the reference's emit strings write."""
    return set(re.findall(r"([a-z_0-9]+)=\{", src)) | set(
        re.findall(r"[;\"]([a-z_0-9]+)=", src))


def test_paper_net_is_the_reference_benchs_network():
    import jax.numpy as jnp

    topo = bench_serving.cm.PAPER_TOPOLOGY
    key = jax.random.PRNGKey(0)
    net = bench_serving.paper_net(0, "cpu")
    for i, w in enumerate(net.weight_bits):
        want = np.asarray(jax.random.bernoulli(
            jax.random.fold_in(key, i), 0.5,
            (topo[i], topo[i + 1])).astype(jnp.int8))
        np.testing.assert_array_equal(w.numpy(), want)
    assert all(int(v.abs().sum()) == 0 for v in net.vth)
    assert not torch.any(net.out_offset)


def test_smoke_run_emits_the_reference_rows(tmp_path, capsys):
    out = tmp_path / "serving.json"
    rows = bench_serving.main(["--device", "cpu", "--smoke", "--requests",
                               "256", "--out", str(out)])
    assert tuple(r["name"] for r in rows) == ROWS
    src = REF.read_text()
    ref_keys = _ref_keys(src)
    for row in rows:
        name = row["name"]
        # a literal name, or a tag the reference's f-string completes
        tag = name.removeprefix("serving_openloop_").removeprefix("serving_")
        assert f'"{name}"' in src or f'"{tag}"' in src, name
        for key in bench_serving.fields(row):
            assert key in ref_keys, (row["name"], key)
    f = {r["name"]: bench_serving.fields(r) for r in rows}
    assert f["serving_single_device"]["requests"] == "256"
    assert f["serving_single_device"]["cell"] == "1RW+4R"
    assert f["serving_single_device"]["data_parallel"] == "1"
    assert "(paper 44)" in f["serving_single_device"]["model_minf_s"]
    assert f["serving_cold_start"]["compilation_cache"] == "off"
    obs = f["serving_obs_overhead"]
    assert obs["requests"] == "256" and obs["gate"] == "5%"
    assert obs["overhead_pct"].endswith("%")
    over = f["serving_openloop_over"]
    assert int(over["shed_total"]) > 0 and float(over["p99_ms"]) > 0
    assert "goodput_slo" in over and "p99_ms" in f["serving_openloop_under"]
    chaos = f["serving_chaos"]
    assert int(chaos["lost"]) == 0 and int(chaos["offered"]) == 48
    with open(out) as fh:
        assert json.load(fh) == {"results": rows}
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == "name,us_per_call,derived"
    assert [line.split(",", 1)[0] for line in printed[1:1 + len(ROWS)]] == (
        list(ROWS))
