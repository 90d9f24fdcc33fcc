"""repro_torch.launch.env and the launcher's --compile-cache on the CPU, and
the small leftovers against the reference: ``NeuronState.zeros``,
``EsamNetwork.n_neurons`` / ``n_synapses`` and the checkpoint's ``async_``
writer, whose files the reference's ``restore`` reads back equal.

No kernel is built here (no nvcc on the CPU): what is held is where the
kernel library cache points, in this process and in a subprocess's
environment."""

from __future__ import annotations

import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bench_rows import one_torch_thread  # noqa: F401 (fixture)

from repro.checkpoint import io as ref_io
from repro.core.esam import neuron as ref_neuron
from repro.core.esam.network import EsamNetwork as RefNetwork
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core.esam import neuron
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.kernels import _build
from repro_torch.launch import env as env_mod

REPO_BUILD = Path(__file__).resolve().parents[1] / "build" / "repro_torch"

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture
def no_cache_env(monkeypatch):
    """The cache variable unset for the test and restored after it, also
    where the code under test writes ``os.environ`` itself (``setenv``
    records the value to restore, then ``delenv`` unsets it)."""
    monkeypatch.setenv(_build.CACHE_ENV, "unset")
    monkeypatch.delenv(_build.CACHE_ENV)
    yield monkeypatch


def test_build_dir_defaults_to_the_repo_and_follows_the_variable(
        no_cache_env, tmp_path):
    assert _build.build_dir() == REPO_BUILD
    no_cache_env.setenv(_build.CACHE_ENV, str(tmp_path / "k"))
    assert _build.build_dir() == tmp_path / "k"
    lib, report = _build._paths("arbiter")
    assert lib.parent == tmp_path / "k" and report.parent == lib.parent


def test_enable_compilation_cache_moves_build_dir(no_cache_env, tmp_path):
    d = tmp_path / "cache" / "nested"
    got = env_mod.enable_compilation_cache(str(d))
    assert got == str(d) and d.is_dir()
    assert os.environ[_build.CACHE_ENV] == str(d)
    assert _build.build_dir() == d
    # a second call without a directory keeps the one set
    assert env_mod.enable_compilation_cache() == str(d)


def test_enable_compilation_cache_default(no_cache_env, tmp_path):
    home = tmp_path / "home"
    no_cache_env.setattr(env_mod, "DEFAULT_CACHE_DIR",
                         str(home / ".cache" / "repro-torch-kernels"))
    got = env_mod.enable_compilation_cache()
    assert got == env_mod.DEFAULT_CACHE_DIR and Path(got).is_dir()
    assert _build.build_dir() == Path(got)


def test_default_cache_dir_is_under_the_home_cache():
    assert env_mod.DEFAULT_CACHE_DIR == os.path.join(
        os.path.expanduser("~"), ".cache", "repro-torch-kernels")


def test_tuned_env_names_the_cache_for_a_subprocess(no_cache_env, tmp_path):
    env = env_mod.tuned_env(str(tmp_path / "a"))
    assert env[_build.CACHE_ENV] == str(tmp_path / "a")
    assert _build.CACHE_ENV not in os.environ     # this process untouched
    assert env_mod.tuned_env()[_build.CACHE_ENV] == env_mod.DEFAULT_CACHE_DIR
    no_cache_env.setenv(_build.CACHE_ENV, str(tmp_path / "b"))
    assert env_mod.tuned_env()[_build.CACHE_ENV] == str(tmp_path / "b")
    assert env["PATH"] == os.environ["PATH"]


@pytest.mark.parametrize("flag", [None, "", "dir"])
def test_launcher_compile_cache_flag(no_cache_env, tmp_path, capsys, flag):
    from repro_torch.launch import serve as serve_mod

    no_cache_env.setattr(env_mod, "DEFAULT_CACHE_DIR", str(tmp_path / "dflt"))
    argv = ["--esam", "--smoke", "--requests", "8", "--device", "cpu",
            "--warmup"]
    if flag is not None:
        argv += ["--compile-cache"] + ([str(tmp_path / "c")] if flag else [])
    run = serve_mod.main(argv)
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("COLDSTART"))
    want = {None: None, "": str(tmp_path / "dflt"), "dir": str(tmp_path / "c")}
    # cache= is the reference's flag; cache_dir= where the libraries live
    # (without the flag, the repo's own build directory)
    assert line.split()[-2:] == [
        "cache=" + ("off" if flag is None else "on"),
        f"cache_dir={want[flag] or _build.build_dir()}"]
    # the CPU builds nothing: no BUILD line
    assert "BUILD" not in out
    assert os.environ.get(_build.CACHE_ENV) == want[flag]
    assert all(r.label is not None for r in run.requests)


def test_build_kernels_is_a_no_op_on_the_cpu(capsys):
    from repro_torch.launch import serve as serve_mod

    assert serve_mod.build_kernels("cpu") == []
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cache", [False, True])
def test_bench_serving_cold_start_reads_the_cache_variable(
        no_cache_env, tmp_path, cache):
    from repro_torch.launch import bench_serving
    from repro_torch.launch.bench_common import Recorder, fields

    if cache:
        env_mod.enable_compilation_cache(str(tmp_path))
    rec = Recorder()
    bench_serving._cold_start_lane(rec, torch.device("cpu"))
    (row,) = rec.rows
    assert row["name"] == "serving_cold_start"
    assert fields(row)["compilation_cache"] == ("on" if cache else "off")


# ----------------------------------------------------------------------- #
# the leftovers
# ----------------------------------------------------------------------- #
@pytest.mark.parametrize("n_out", [1, 10, 257])
def test_neuron_state_zeros_matches_the_reference(n_out):
    got = neuron.NeuronState.zeros(n_out, device="cpu")
    want = ref_neuron.NeuronState.zeros(n_out)
    np.testing.assert_array_equal(got.vmem.numpy(), np.asarray(want.vmem))
    np.testing.assert_array_equal(got.fired.numpy(), np.asarray(want.fired))
    assert got.vmem.dtype == torch.int32 and got.fired.dtype == torch.bool


def test_neuron_state_zeros_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        neuron.NeuronState.zeros(4)


@pytest.mark.parametrize("topology", [(768, 10), (768, 256, 10),
                                      (768, 256, 256, 256, 10), (100, 7, 3)])
def test_network_sizes_match_the_reference(topology):
    rng = np.random.default_rng(0)
    bits = [rng.integers(0, 2, (topology[i], topology[i + 1]), np.int8)
            for i in range(len(topology) - 1)]
    vth = [np.zeros((n,), np.int32) for n in topology[1:]]
    off = np.zeros((topology[-1],), np.float32)
    got = EsamNetwork.from_numpy(bits, vth, off, device="cpu")
    want = RefNetwork(weight_bits=[jnp.asarray(b) for b in bits],
                      vth=[jnp.asarray(v) for v in vth],
                      out_offset=jnp.asarray(off))
    assert got.n_neurons == want.n_neurons
    assert got.n_synapses == want.n_synapses


@pytest.mark.parametrize("async_", [False, True])
def test_checkpoint_async_writer_read_back_by_the_reference(tmp_path, async_):
    tree = {"weight_bits": [torch.arange(12, dtype=torch.int8).reshape(3, 4),
                            torch.ones((4, 2), dtype=torch.int8)],
            "vth": torch.tensor([1, -2], dtype=torch.int32),
            "scale": np.float32(0.5) * np.ones((3,), np.float32)}
    thread = ckpt_io.save(tree, str(tmp_path), 7, extra={"acc": 0.5},
                          async_=async_)
    if async_:
        # the leaves were copied before save returned: a later write to
        # the caller's tensor does not reach the checkpoint
        tree["vth"][0] = 99
        thread.join(timeout=60)
        assert not thread.is_alive()
    else:
        assert thread is None
    like = {"weight_bits": [jnp.zeros((3, 4), jnp.int8),
                            jnp.zeros((4, 2), jnp.int8)],
            "vth": jnp.zeros((2,), jnp.int32),
            "scale": jnp.zeros((3,), jnp.float32)}
    got, manifest = ref_io.restore(like, str(tmp_path), 7)
    assert manifest["step"] == 7 and manifest["extra"] == {"acc": 0.5}
    np.testing.assert_array_equal(np.asarray(got["weight_bits"][0]),
                                  np.arange(12, dtype=np.int8).reshape(3, 4))
    np.testing.assert_array_equal(np.asarray(got["weight_bits"][1]),
                                  np.ones((4, 2), np.int8))
    np.testing.assert_array_equal(np.asarray(got["vth"]), [1, -2])
    np.testing.assert_array_equal(np.asarray(got["scale"]),
                                  np.full((3,), 0.5, np.float32))
    assert ckpt_io.latest_step(str(tmp_path)) == ref_io.latest_step(
        str(tmp_path)) == 7


def test_checkpoint_async_matches_the_reference_writer(tmp_path):
    """The reference's async writer and the port's write the same files."""
    ref_tree = {"w": [jnp.arange(6, dtype=jnp.int8)], "v": jnp.ones((2,))}
    port_tree = {"w": [torch.arange(6, dtype=torch.int8)],
                 "v": torch.ones((2,))}
    ref_io.save(ref_tree, str(tmp_path / "ref"), 1, async_=True).join(60)
    ckpt_io.save(port_tree, str(tmp_path / "port"), 1, async_=True).join(60)
    for d in ("ref", "port"):
        got, _ = ckpt_io.restore(port_tree, str(tmp_path / d), 1)
        torch.testing.assert_close(got["w"][0], port_tree["w"][0],
                                   rtol=0, atol=0)
        torch.testing.assert_close(got["v"], port_tree["v"], rtol=0, atol=0)
