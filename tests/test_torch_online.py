"""repro_torch.train.online and repro_torch.checkpoint.io against the JAX
package, on the network of the reference's train_online tests (768:64:10,
256 digits).

The same numpy weights and data and the same PRNGKey go through both
``train_online``s: final readout bits equal, accuracies equal as float32
values, update counts equal — with shuffle on and off, a nonzero
``out_offset``, an eval split, and checkpoint-then-resume.  A checkpoint
written by either package is restored by the other."""

from __future__ import annotations

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.core.esam.network import EsamNetwork as JaxNetwork
from repro.data import digits
from repro.train import online as jonline
from repro_torch.checkpoint import io as ckpt
from repro_torch.core import prng
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.train import online


def _fixture(offset=False):
    """The network and data of the reference's train_online tests
    (tests/test_online_plane.py:194-206), plus an optional nonzero readout
    offset; (jax net, port net, x, y)."""
    topo = (768, 64, 10)
    key = jax.random.PRNGKey(1)
    bits = [np.asarray(jax.random.bernoulli(
        jax.random.fold_in(key, i), 0.5, (topo[i], topo[i + 1]))).astype(np.int8)
        for i in range(2)]
    vth = [np.zeros((64,), np.int32), np.full((10,), 2**31 - 1, np.int32)]
    off = (np.random.default_rng(0).normal(size=10).astype(np.float32)
           if offset else np.zeros((10,), np.float32))
    jnet = JaxNetwork(weight_bits=[jnp.asarray(b) for b in bits],
                      vth=[jnp.asarray(v) for v in vth],
                      out_offset=jnp.asarray(off))
    net = EsamNetwork.from_numpy(bits, vth, off, device="cpu")
    x, y = digits.make_spike_dataset(256, seed=11)
    return jnet, net, x, y


def _assert_same(jres, res):
    np.testing.assert_array_equal(res.network.weight_bits[-1].numpy(),
                                  np.asarray(jres.network.weight_bits[-1]))
    assert res.accuracy == [float(a) for a in jres.accuracy]
    assert res.n_updates == jres.n_updates
    assert (res.start_epoch, res.epochs_run) == (jres.start_epoch,
                                                 jres.epochs_run)


def _port_key(seed):
    return prng.PRNGKey(seed)


def test_prngkey_from_the_prng_matches_the_fixture_weights():
    """The fixture's weights drawn with the port's prng are the same bits."""
    jnet, net, _, _ = _fixture()
    for i, w in enumerate(net.weight_bits):
        got = prng.bernoulli(prng.fold_in(prng.PRNGKey(1), i), 0.5,
                             tuple(w.shape)).to(torch.int8)
        assert torch.equal(got, w)


@pytest.mark.parametrize("shuffle,offset,eval_split", [
    (False, False, False), (True, True, True), (True, False, False)])
def test_train_online_matches_reference(shuffle, offset, eval_split):
    jnet, net, x, y = _fixture(offset)
    kw = dict(epochs=3, p_pot=0.2, p_dep=0.1, shuffle=shuffle)
    jkw, tkw = dict(kw), dict(kw)
    if eval_split:   # 100 samples: a count/n that is not a power of two
        jkw.update(eval_spikes=jnp.asarray(x[:100]).astype(bool),
                   eval_labels=jnp.asarray(y[:100]))
        tkw.update(eval_spikes=x[:100], eval_labels=torch.from_numpy(y[:100]))
    jres = jonline.train_online(jnet, jnp.asarray(x).astype(bool),
                                jnp.asarray(y), key=jax.random.PRNGKey(5),
                                **jkw)
    res = online.train_online(net, x, y, key=_port_key(5), **tkw)
    _assert_same(jres, res)
    assert len(res.epoch_s) == 3
    # the prefix tiles and the caller's network are untouched
    assert torch.equal(res.network.weight_bits[0], net.weight_bits[0])
    assert not torch.equal(res.network.weight_bits[1], net.weight_bits[1])
    # the tracked accuracy is the deployed readout's
    ex, ey = (x[:100], y[:100]) if eval_split else (x, y)
    logits = res.network.plan(mode="functional")(ex).logits
    acc = float((logits.argmax(-1).numpy() == ey).mean())
    assert abs(acc - res.accuracy[-1]) < 1e-6


def test_checkpoint_resume_matches_reference(tmp_path):
    """2 epochs + checkpoint + resume to 4 == the reference's straight run,
    and the reference resumes from the port's checkpoint to the same end."""
    jnet, net, x, y = _fixture(offset=True)
    kw = dict(p_pot=0.2, p_dep=0.1, shuffle=True)
    straight = jonline.train_online(
        jnet, jnp.asarray(x).astype(bool), jnp.asarray(y), epochs=4,
        key=jax.random.PRNGKey(5), **kw)
    d = str(tmp_path / "port")
    first = online.train_online(net, x, y, epochs=2, key=_port_key(5),
                                checkpoint_dir=d, checkpoint_every=1, **kw)
    assert first.epochs_run == 2 and ckpt.latest_step(d) == 2
    resumed = online.train_online(net, x, y, epochs=4, key=_port_key(5),
                                  checkpoint_dir=d, resume=True, **kw)
    assert resumed.start_epoch == 2 and resumed.epochs_run == 2
    np.testing.assert_array_equal(
        resumed.network.weight_bits[-1].numpy(),
        np.asarray(straight.network.weight_bits[-1]))
    assert resumed.accuracy == [float(a) for a in straight.accuracy[2:]]
    assert resumed.n_updates == straight.n_updates[2:]
    # the reference picks up the port's step-2 checkpoint
    shutil.rmtree(f"{d}/step_00000004")
    jres = jonline.train_online(
        jnet, jnp.asarray(x).astype(bool), jnp.asarray(y), epochs=4,
        key=jax.random.PRNGKey(5), checkpoint_dir=d, resume=True, **kw)
    assert jres.start_epoch == 2
    np.testing.assert_array_equal(
        np.asarray(jres.network.weight_bits[-1]),
        np.asarray(straight.network.weight_bits[-1]))


def test_checkpoints_cross_packages(tmp_path):
    rng = np.random.default_rng(3)
    bits = [rng.integers(0, 2, size=(70, 32), dtype=np.int8),
            rng.integers(0, 2, size=(32, 10), dtype=np.int8)]
    extra = {"accuracy": 0.5, "n_updates": 12}
    # JAX writes, the port reads
    jdir = str(tmp_path / "jax")
    jckpt.save({"weight_bits": [jnp.asarray(b) for b in bits]}, jdir, 3,
               extra=extra)
    like = {"weight_bits": [torch.zeros(b.shape, dtype=torch.int8)
                            for b in bits]}
    assert ckpt.latest_step(jdir) == 3
    got, manifest = ckpt.restore(like, jdir, 3)
    assert manifest["extra"] == extra and manifest["step"] == 3
    for g, b in zip(got["weight_bits"], bits):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), b)
    # the port writes, JAX reads
    pdir = str(tmp_path / "port")
    for step in (7, 9):
        ckpt.save({"weight_bits": [torch.from_numpy(b) for b in bits]}, pdir,
                  step, extra=extra)
    assert jckpt.latest_step(pdir) == 9
    jgot, jman = jckpt.restore(
        {"weight_bits": [jnp.zeros(b.shape, jnp.int8) for b in bits]}, pdir, 7)
    assert jman == manifest | {"step": 7}
    for g, b in zip(jgot["weight_bits"], bits):
        np.testing.assert_array_equal(np.asarray(g), b)
    ckpt.prune_old(pdir, keep=1)
    assert ckpt.latest_step(pdir) == 9
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "step_00000009"]


def test_train_online_rejects_partial_eval_split():
    _, net, x, y = _fixture()
    with pytest.raises(ValueError, match="eval_labels"):
        online.train_online(net, x, y, epochs=1, eval_spikes=x)
    with pytest.raises(ValueError, match="eval_labels"):
        online.train_online(net, x, y, epochs=1, eval_labels=y)
