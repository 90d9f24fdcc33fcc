"""repro_torch BNN and BNN -> SNN conversion against repro's, and the port's
quickstart.

On the JAX package's own trained params, carried across with
``bnn.params_from_numpy``: the exact hidden activations and the converted
network (weight bits, thresholds, readout offset) bit for bit; the forward
logits to 1e-5 absolute (they are exact integers times a float32 scale, so
in practice equal); the loss and the STE gradients of one batch to 1e-5
relative to each gradient's largest entry (float32 products summed in
another order); one Adam step: its moments to the same tolerance, and its
update fed the reference's gradients to 1e-5 relative to each parameter's
largest entry (Adam divides by sqrt(v) + 1e-8, so where a gradient entry
is near 1e-8 a rounding difference in it becomes a visible step
difference; feeding the same gradients holds the update itself).  The
port's own training is held to the reference's accuracy bars, not to
bits."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.esam import bnn as jbnn
from repro.core.esam import conversion as jconversion
from repro.core.esam.network import system_stats as jsystem_stats
from repro_torch.core import prng
from repro_torch.core.esam import bnn, conversion
from repro_torch.core.esam import cost_model as cm
from repro_torch.data import digits
from repro_torch.launch import quickstart

SMALL = (768, 64, 64, 10)


@pytest.fixture(scope="module")
def trained():
    """The reference's params after a short fit, and both packages' copies."""
    x, y = digits.make_spike_dataset(512, seed=0)
    jparams, _ = jbnn.fit(jax.random.PRNGKey(0), SMALL, jnp.asarray(x),
                          jnp.asarray(y), steps=40, batch=128)
    host = [{k: np.asarray(v) for k, v in layer.items()} for layer in jparams]
    return host, bnn.params_from_numpy(host, device="cpu"), x, y


def _jparams(host):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in host]


def test_params_round_trip(trained):
    host, params, _, _ = trained
    for a, b in zip(bnn.params_to_numpy(params), host):
        for k in ("w", "b"):
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])


def test_hidden_activations_and_conversion_bit_identical(trained):
    host, params, x, _ = trained
    xb = torch.from_numpy(x[:256]).float()
    want = jbnn.hidden_activations(_jparams(host), jnp.asarray(x[:256],
                                                               jnp.float32))
    for g, w in zip(bnn.hidden_activations(params, xb), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    net = conversion.bnn_to_snn(params)
    jnet = jconversion.bnn_to_snn(_jparams(host))
    assert net.device == torch.device("cpu")
    for g, w in zip(net.weight_bits, jnet.weight_bits):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(net.vth, jnet.vth):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(net.vth[-1].min()) == np.iinfo(np.int32).max   # never fires
    np.testing.assert_array_equal(net.out_offset.numpy(),
                                  np.asarray(jnet.out_offset))
    # the SNN's hidden spikes are the BNN's activations
    res = net.plan(mode="functional", collect=True)(xb != 0)
    for a, s in zip(bnn.hidden_activations(params, xb), res.planes):
        assert torch.equal(a > 0, s)


def test_forward_logits_agree(trained):
    host, params, x, _ = trained
    want = np.asarray(jbnn.forward(_jparams(host), jnp.asarray(x, jnp.float32)))
    got = bnn.forward(params, torch.from_numpy(x).float()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_conversion_preserves_accuracy_exactly(trained):
    _, params, x, _ = trained
    xt = torch.from_numpy(x).float()
    net = conversion.bnn_to_snn(params)
    pred = net.plan(mode="functional")(xt != 0).logits.argmax(-1)
    assert torch.equal(pred, bnn.forward(params, xt).argmax(-1))


def _close_to_largest(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def test_loss_and_ste_gradients_match_jax(trained):
    host, params, x, y = trained
    xb, yb = x[:256], y[:256]
    (jloss, _), jgrads = jax.value_and_grad(jbnn.loss_fn, has_aux=True)(
        _jparams(host), jnp.asarray(xb, jnp.float32), jnp.asarray(yb))
    loss, logits, grads = bnn.grads(params, torch.from_numpy(xb).float(),
                                    torch.from_numpy(yb))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    lv, _ = bnn.loss_fn(params, torch.from_numpy(xb).float(),
                        torch.from_numpy(yb))
    assert float(lv) == float(loss)
    assert logits.shape == (256, 10)
    for g, w in zip(grads, jgrads):
        for k in ("w", "b"):
            assert g[k].dtype == torch.float32
            _close_to_largest(g[k].numpy(), w[k])


def test_ste_sign_backward_is_clipped_identity():
    z = torch.tensor([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0],
                     requires_grad=True)
    out = bnn.ste_sign(z)
    assert out.tolist() == [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0, 1.0]
    (g,) = torch.autograd.grad(out.sum(), z)
    want = jax.grad(lambda v: jbnn.ste_sign(v).sum())(
        jnp.asarray(z.detach().numpy()))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))


def test_train_step_matches_jax(trained):
    """One step, held in its two halves: the port's own step against the
    reference's (loss, accuracy and both Adam moments, which are linear in
    the gradients), and the port's Adam update fed the reference's
    gradients against the reference's new parameters."""
    host, params, x, y = trained
    xb, yb = x[:128], y[:128]
    jp, jopt = _jparams(host), jbnn.init_opt_state(_jparams(host))
    jx, jy = jnp.asarray(xb, jnp.float32), jnp.asarray(yb)
    _, jgrads = jax.jit(jax.value_and_grad(jbnn.loss_fn, has_aux=True))(
        jp, jx, jy)
    jp2, (jm, jv, jt), jloss, jacc = jbnn.train_step(jp, jopt, jx, jy, 3e-3)
    opt0 = bnn.init_opt_state(params)
    p2, (m, v, t), loss, acc = bnn.train_step(
        params, opt0, torch.from_numpy(xb).float(), torch.from_numpy(yb),
        3e-3)
    assert t == int(jt) == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(acc) == float(jacc)
    for tree, jtree in ((m, jm), (v, jv)):
        for g, w in zip(tree, jtree):
            for k in ("w", "b"):
                _close_to_largest(g[k].numpy(), w[k])
    fed = [{k: torch.tensor(np.asarray(layer[k])) for k in ("w", "b")}
           for layer in jgrads]
    p2_fed, _ = bnn.adam_update(params, opt0, fed, 3e-3)
    for g, w in zip(p2_fed, jp2):
        for k in ("w", "b"):
            _close_to_largest(g[k].numpy(), w[k])
    for layer in p2:
        assert float(layer["w"].abs().max()) <= bnn.LATENT_CLIP


def test_fit_reaches_the_reference_bar():
    """The reference's own bar (tests/test_bnn_conversion.py): > 0.9 train
    accuracy at (768, 64, 64, 10) after 200 steps."""
    x, y = digits.make_spike_dataset(2048, seed=0)
    params, acc = bnn.fit(prng.PRNGKey(0), SMALL, x, y, steps=200,
                          batch=128, lr=3e-3, device="cpu")
    assert acc > 0.9
    assert [tuple(layer["w"].shape) for layer in params] == [
        (768, 64), (64, 64), (64, 10)]


def test_paper_topology_trains_and_converts():
    x, y = digits.make_spike_dataset(1024, seed=1)
    params, _ = bnn.fit(prng.PRNGKey(1), cm.PAPER_TOPOLOGY, x, y, steps=120,
                        batch=128, device="cpu")
    net = conversion.bnn_to_snn(params)
    assert net.topology == cm.PAPER_TOPOLOGY
    pred = net.plan(mode="functional")(torch.from_numpy(x[:512])).logits
    snn_acc = float((pred.argmax(-1) == torch.from_numpy(y[:512])).float()
                    .mean())
    assert snn_acc > 0.8


def test_single_layer_conversion_regression():
    """A one-tile BNN converts: its only tile is the readout, its inputs are
    {0,1} spikes, so offset = b exactly and the SNN scores are the BNN
    logits up to the positive 1/sqrt(fan_in) scale."""
    rng = np.random.default_rng(7)
    host = [{"w": rng.normal(size=(32, 10)).astype(np.float32),
             "b": rng.normal(size=(10,)).astype(np.float32)}]
    params = bnn.params_from_numpy(host, device="cpu")
    net = conversion.bnn_to_snn(params)
    jnet = jconversion.bnn_to_snn(_jparams(host))
    assert net.topology == (32, 10)
    np.testing.assert_array_equal(net.out_offset.numpy(), host[0]["b"])
    np.testing.assert_array_equal(net.vth[0].numpy(), np.asarray(jnet.vth[0]))
    x = torch.from_numpy(rng.random((64, 32)) < 0.5)
    scores = net.plan(mode="functional")(x).logits
    want = x.float() @ bnn.sign_pm1(params[0]["w"]) + params[0]["b"]
    np.testing.assert_allclose(scores.numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
    assert torch.equal(scores.argmax(-1),
                       bnn.forward(params, x.float()).argmax(-1))


def test_quickstart_smoke_on_cpu(capsys):
    run = quickstart.main(["--smoke", "--device", "cpu"])
    assert run.net.topology == cm.PAPER_TOPOLOGY
    assert run.packed_equal
    assert torch.equal(run.sample_logits, run.logits[0])
    loads0 = [ld[0].numpy() for ld in run.loads]
    assert run.cycles == [int(np.ceil(ld / 4).max()) for ld in loads0]
    counts = [ld[:quickstart.CHECK_SAMPLES].numpy().astype(np.float64)
              for ld in run.loads]
    for p, s in enumerate(run.fig8):
        assert dataclasses.asdict(s) == dataclasses.asdict(
            jsystem_stats(cm.PAPER_TOPOLOGY, counts, p))
    assert run.speedup == pytest.approx(cm.PAPER_SPEEDUP_4R, rel=0.05)
    assert run.energy_eff == pytest.approx(cm.PAPER_ENERGY_EFF_4R, rel=0.05)
    assert 0.0 <= run.snn_accuracy <= 1.0
    out = capsys.readouterr().out
    for step in ("== 1.", "== 2.", "== 2b.", "== 3.", "== 4."):
        assert step in out
    assert "MInf/s" in out and "headline" in out


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bnn.init_params(prng.PRNGKey(0), SMALL)
    with pytest.raises(RuntimeError):
        quickstart.main(["--smoke"])


def test_init_params_within_3_ulp_of_reference():
    """The latent init draws ``prng.normal``: every weight within 3 ulp of
    the reference's ``jax.random.normal`` init, the biases zero."""
    want = jbnn.init_params(jax.random.PRNGKey(0), SMALL)
    got = bnn.init_params(prng.PRNGKey(0), SMALL, device="cpu")
    for g, w in zip(got, want):
        wj = np.asarray(w["w"])
        ulp = np.abs(g["w"].numpy().view(np.int32).astype(np.int64)
                     - wj.view(np.int32))
        assert g["w"].dtype == torch.float32 and ulp.max() <= 3
        assert not torch.any(g["b"])
