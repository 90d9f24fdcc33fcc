"""Online learning through the transposable port (Sec 4.4.1 + [16]), the
twin of the reference's ``examples/online_learning.py``.

    python -m repro_torch.launch.online_learning              # on the card
    python -m repro_torch.launch.online_learning --device cpu

A deployed SNN with a random readout adapts on the device through
supervised stochastic STDP: 768 synthetic digits (``seed=3``), a 768 -> 10
readout drawn as ``bernoulli(PRNGKey(0), 0.5)`` through ``core/prng.py``
(the reference's bits), thresholds 2^31 - 1 (the readout never fires),
and ``train_online`` for 6 epochs under ``PRNGKey(10)`` with ``p_pot``
0.2 and ``p_dep`` 0.1.  Each epoch on the card is ``stdp_epoch_masks``
and ``stdp_column_epoch``, two launches.  Prints the reference's table:
accuracy and column updates an epoch, with the hardware time and energy
of the updates on the 1RW baseline and the 1RW+4R cell (the 26.0x / 19.5x
claim, end to end).  The draws are the reference's, so the table is too.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.esam import learning
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.data import digits
from repro_torch.kernels.common import resolve_device
from repro_torch.train import online as online_train

N_SAMPLES, DATA_SEED, EPOCHS = 768, 3, 6
P_POT, P_DEP = 0.2, 0.1


def readout_network(device) -> EsamNetwork:
    """The example's 768 -> 10 network: ``bernoulli(PRNGKey(0), 0.5)``
    bits, thresholds 2^31 - 1, zero offsets."""
    bits = prng.bernoulli(prng.PRNGKey(0, device), 0.5, (768, 10)).to(
        torch.int8)
    return EsamNetwork([bits], [torch.full((10,), 2**31 - 1,
                                           dtype=torch.int32)],
                       torch.zeros((10,)), device=device)


def run(*, device="cuda", epochs: int = EPOCHS
        ) -> tuple[float, online_train.OnlineTrainResult]:
    """Train and print the table; returns (the accuracy before training,
    the ``train_online`` result)."""
    dev = resolve_device(device)
    xn, yn = digits.make_spike_dataset(N_SAMPLES, seed=DATA_SEED)
    x = torch.from_numpy(xn != 0).to(dev)
    y = torch.from_numpy(np.asarray(yn)).to(dev)
    net = readout_network(dev)

    c4 = learning.column_update_cost(4)
    c0 = learning.column_update_cost(0)
    print(f"column update: 1RW read {c0.read_ns:.1f}ns/write "
          f"{c0.write_ns:.1f}ns | 4R transposed read {c4.read_ns}ns "
          f"({c4.speedup_read_vs_1rw:.1f}x) write {c4.write_ns}ns "
          f"({c4.speedup_write_vs_1rw:.1f}x)")

    logits = net.plan(mode="functional")(x).logits
    acc0 = float((logits.argmax(-1) == y).to(torch.float32).mean())
    res = online_train.train_online(
        net, x, y, epochs=epochs, key=prng.PRNGKey(10, dev), p_pot=P_POT,
        p_dep=P_DEP)

    print("epoch  accuracy  col-updates  t_4R(us)  t_1RW(us)  E_4R(nJ)  "
          "E_1RW(nJ)")
    print(f"  --   {acc0 * 100:7.1f}%")
    for epoch, (acc, n) in enumerate(zip(res.accuracy, res.n_updates)):
        t4 = n * (c4.read_ns + c4.write_ns) * 1e-3
        t0 = n * (c0.read_ns + c0.write_ns) * 1e-3
        e4 = n * c4.energy_pj * 1e-3
        e0 = n * c0.energy_pj * 1e-3
        print(f"  {epoch:2d}   {acc * 100:7.1f}%  {n:10d}  {t4:8.1f}  "
              f"{t0:9.1f}  {e4:8.2f}  {e0:8.1f}")
    print(f"total column updates: {sum(res.n_updates)}")
    return acc0, res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
