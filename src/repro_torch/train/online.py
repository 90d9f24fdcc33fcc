"""Multi-epoch online learning of the readout on the column-event plane.

The port of the reference's ``repro.train.online``.  A converted SNN ships
with frozen hidden tiles and adapts its readout on the device through
supervised stochastic STDP, every update a column access through the
transposable port (Sec 4.4.1):

* the frozen prefix runs ONCE through ``network.plan(mode="prefix")`` (one
  ``popcount_fire`` launch per hidden tile on the card) for the training and
  eval splits, and is reused by every epoch;
* the readout bits stay transposed-resident (``{0,1}[n_out, n_in]``) on the
  device across epochs, updated in place by ``learning.column_event_epoch``;
* accuracy is read per epoch from the resident layout, and checkpoints are
  written through ``checkpoint.io`` in the network's ``[n_in, n_out]``
  layout, the reference's format, so either package resumes the other's.

Under the same key the draws are the reference's (``core/prng.py``), so the
weights, accuracies and update counts are the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import packing, prng
from repro_torch.core.esam import learning
from repro_torch.core.esam.network import EsamNetwork


def _readout_accuracy(bits_t, pre, labels, out_offset) -> float:
    """argmax accuracy of the transposed-resident readout on (pre, labels).

    The reference's jitted float32 mean multiplies the count by the float32
    reciprocal of n (XLA folds the division by a constant); the same two
    roundings here give the same float."""
    logits = learning.readout_vmem(bits_t, pre).to(torch.float32) + out_offset
    correct = int((logits.argmax(-1) == labels).sum())
    return float(np.float32(correct)
                 * (np.float32(1) / np.float32(labels.shape[0])))


@dataclasses.dataclass
class OnlineTrainResult:
    network: EsamNetwork        # prefix unchanged, learned last tile swapped in
    accuracy: list[float]       # eval accuracy after each epoch run
    n_updates: list[int]        # column updates per epoch (feeds the cost model)
    start_epoch: int            # 0, or where a resumed run picked up
    epochs_run: int
    #: host wall seconds of each epoch run (learning + accuracy readout)
    epoch_s: list[float] = dataclasses.field(default_factory=list)


def _checkpoint_tree(network: EsamNetwork, bits_t: torch.Tensor) -> dict:
    return {"weight_bits": list(network.weight_bits[:-1]) + [bits_t.T]}


def train_online(
    network: EsamNetwork,
    spikes,                      # {0,1}[batch, n_in]
    labels,                      # integer [batch]
    *,
    epochs: int = 5,
    key: torch.Tensor | None = None,
    p_pot: float = 0.12,
    p_dep: float = 0.06,
    eval_spikes=None,
    eval_labels=None,
    shuffle: bool = False,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    resume: bool = False,
) -> OnlineTrainResult:
    """Supervised-STDP training of the readout tile over several epochs.

    Runs on the network's device.  Evaluation defaults to the training set
    when no eval split is given.  ``shuffle=True`` permutes the sample order
    per epoch (``permutation(fold_in(epoch_key, n_samples))``).  With
    ``checkpoint_dir`` set, the full weight list is checkpointed every
    ``checkpoint_every`` epochs and at the end; ``resume=True`` restarts from
    the latest step found there.
    """
    if key is None:
        key = prng.PRNGKey(0)
    if (eval_spikes is None) != (eval_labels is None):
        raise ValueError("eval_spikes and eval_labels must be given together")
    dev = network.device
    key = key.to(dev)
    spikes = torch.as_tensor(spikes).to(dev) != 0
    labels = torch.as_tensor(labels).to(dev)
    prefix_plan = network.plan(mode="prefix")
    n_pre = network.topology[-2]

    def run_prefix(x):
        out = prefix_plan(x).prefix
        if prefix_plan.prefix_packed:
            out = packing.unpack_spikes(out, n_pre, torch.bool)
        return out

    pre = run_prefix(spikes)
    if eval_spikes is None:
        eval_pre, eval_labels = pre, labels
    else:
        eval_pre = run_prefix(torch.as_tensor(eval_spikes).to(dev) != 0)
        eval_labels = torch.as_tensor(eval_labels).to(dev)

    bits_t = network.weight_bits[-1].T.clone(
        memory_format=torch.contiguous_format)
    start_epoch = 0
    if resume and checkpoint_dir is not None:
        step = ckpt_io.latest_step(checkpoint_dir)
        if step is not None:
            restored, _ = ckpt_io.restore(
                _checkpoint_tree(network, bits_t), checkpoint_dir, step)
            bits_t = restored["weight_bits"][-1].T.contiguous()
            start_epoch = step

    n_samples = int(spikes.shape[0])
    accuracy: list[float] = []
    n_updates: list[int] = []
    epoch_s: list[float] = []
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        ep_key = prng.fold_in(key, epoch)
        if shuffle:
            # sample draws fold in indices 0..n_samples-1; n_samples is free
            perm = prng.permutation(prng.fold_in(ep_key, n_samples), n_samples)
            x_e, y_e = pre[perm], labels[perm]
        else:
            x_e, y_e = pre, labels
        # learning events target the deployed readout: the wrong winner is
        # the argmax of the offset-shifted logits, as in _readout_accuracy
        bits_t, n = learning.column_event_epoch(
            bits_t, x_e, y_e, ep_key, p_pot=float(p_pot), p_dep=float(p_dep),
            out_offset=network.out_offset)
        accuracy.append(_readout_accuracy(
            bits_t, eval_pre, eval_labels, network.out_offset))
        n_updates.append(int(n))
        epoch_s.append(time.perf_counter() - t0)
        at_end = epoch + 1 == epochs
        if checkpoint_dir is not None and (
            at_end or (checkpoint_every and (epoch + 1) % checkpoint_every == 0)
        ):
            ckpt_io.save(
                _checkpoint_tree(network, bits_t), checkpoint_dir, epoch + 1,
                extra={"accuracy": accuracy[-1], "n_updates": n_updates[-1]})

    new_net = EsamNetwork(
        [w.clone() for w in network.weight_bits[:-1]] + [bits_t.T.contiguous()],
        [v.clone() for v in network.vth], network.out_offset.clone(),
        device=dev)
    return OnlineTrainResult(
        network=new_net,
        accuracy=accuracy,
        n_updates=n_updates,
        start_epoch=start_epoch,
        epochs_run=len(accuracy),
        epoch_s=epoch_s,
    )
