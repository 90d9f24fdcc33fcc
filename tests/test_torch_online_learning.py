"""The online-learning example (``launch.online_learning``) on the CPU
against the reference's ``examples/online_learning.py``: its per-epoch
accuracy, column updates, learned bits and printed table equal the
reference example's ``train_online`` result (2 epochs here; the entry
point runs 6)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_bench_rows import one_torch_thread  # noqa: F401

from repro_torch.launch import online_learning

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_online_learning_example_equals_the_reference(capsys):
    from repro.core.esam.network import EsamNetwork as RefNetwork
    from repro.data import digits as ref_digits
    from repro.train import online as ref_online

    epochs = 2
    acc0, res = online_learning.run(device="cpu", epochs=epochs)
    out = capsys.readouterr().out
    x, y = ref_digits.make_spike_dataset(768, seed=3)
    x, y = jnp.asarray(x).astype(bool), jnp.asarray(y)
    bits = jax.random.bernoulli(jax.random.PRNGKey(0), 0.5,
                                (768, 10)).astype(jnp.int8)
    np.testing.assert_array_equal(
        online_learning.readout_network("cpu").weight_bits[0].numpy(),
        np.asarray(bits))
    net = RefNetwork(weight_bits=[bits],
                     vth=[jnp.full((10,), 2**31 - 1, jnp.int32)],
                     out_offset=jnp.zeros((10,)))
    want = ref_online.train_online(net, x, y, epochs=epochs,
                                   key=jax.random.PRNGKey(10), p_pot=0.2,
                                   p_dep=0.1)
    assert res.accuracy == [float(a) for a in want.accuracy]
    assert res.n_updates == [int(n) for n in want.n_updates]
    ref_acc0 = float((jnp.argmax(net.plan(mode="functional")(x).logits, -1)
                      == y).mean())
    assert acc0 == ref_acc0
    # the reference example's table, line for line
    lines = out.splitlines()
    assert lines[1].startswith("epoch  accuracy  col-updates")
    assert f"  --   {ref_acc0 * 100:7.1f}%" in lines
    assert lines[-1] == f"total column updates: {sum(want.n_updates)}"
    np.testing.assert_array_equal(
        res.network.weight_bits[0].numpy(),
        np.asarray(want.network.weight_bits[0]))
