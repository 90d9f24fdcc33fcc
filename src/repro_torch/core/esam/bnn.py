"""Binary Neural Network training (Sec 4.4.2 setup).

The paper trains the 768:256:256:256:10 network "as a Binary Neural Network
(BNN) with a sign activation function and per-neuron biases", then converts
it to a binary-SNN with per-neuron thresholds (Kim et al. [15]).  This module
is the training half: straight-through-estimator (STE) training of a
sign-weight, sign-activation MLP in PyTorch.

Conventions (must match conversion.py exactly):
  * first-layer inputs are binary spikes in {0,1};
  * hidden activations are sign(z) in {-1,+1} with sign(0) = +1;
  * weights used in the forward pass are sign(latent) in {-1,+1};
  * every layer has a real-valued per-neuron bias;
  * the last layer emits real logits (no activation).

Parameters are a list of ``{"w": float32[n_in, n_out], "b": float32[n_out]}``
dicts, the reference's layout; ``params_from_numpy`` / ``params_to_numpy``
carry them across.  Training is held to accuracy, not to bits: the init and
the batch draws come from ``core/prng.py`` (the normal init follows
``jax.random.normal``'s construction, but its ``erfinv`` rounds differently).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.kernels.common import resolve_device

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
#: latent-weight clip that keeps the STE window alive (standard BNN practice)
LATENT_CLIP = 1.5


def sign_pm1(x: torch.Tensor) -> torch.Tensor:
    """sign with sign(0) = +1 (the hardware compare is V_mem >= V_th)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def ste_sign(x: torch.Tensor) -> torch.Tensor:
    """Forward sign, backward clipped identity (hard-tanh STE).

    The clip is ``minimum(maximum(x, -1), 1)``, as ``jnp.clip`` computes
    it, so at exactly ±1 the gradient is halved as the reference's is."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    clipped = torch.minimum(torch.maximum(x, -one), one)
    return clipped + (sign_pm1(x) - clipped).detach()


def _inv_sqrt(fan_in: int) -> np.float32:
    """1/sqrt(fan_in) rounded as float32 ops round it (the reference's)."""
    return np.float32(1.0) / np.sqrt(np.float32(fan_in))


def _normal(key: torch.Tensor, shape) -> torch.Tensor:
    """Standard normals built as ``jax.random.normal`` builds them: a
    uniform on (-1, 1) from the key's bits, then sqrt(2) * erfinv."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = prng.uniform(key, shape) * (1.0 - lo) + lo
    return math.sqrt(2.0) * torch.erfinv(torch.clamp(u, min=lo))


def init_params(key: torch.Tensor, topology: Sequence[int],
                device="cuda") -> list[dict]:
    """Latent weights N(0, 1/fan_in) and zero biases, one key split per
    layer; on ``device`` (the card unless asked otherwise)."""
    dev = resolve_device(device)
    key = key.to(dev)
    params = []
    for i in range(len(topology) - 1):
        key, sub = prng.split(key)
        w = _normal(sub, (topology[i], topology[i + 1]))
        params.append({"w": w * _inv_sqrt(topology[i]),
                       "b": torch.zeros((topology[i + 1],), device=dev)})
    return params


def params_from_numpy(params: Sequence[dict], device="cuda") -> list[dict]:
    """``[{"w", "b"}]`` host arrays (e.g. a reference BNN's params through
    ``np.asarray``) as float32 tensors on ``device``."""
    dev = resolve_device(device)
    return [{k: torch.tensor(np.asarray(layer[k], np.float32), device=dev)
             for k in ("w", "b")} for layer in params]


def params_to_numpy(params: Sequence[dict]) -> list[dict]:
    """The inverse of :func:`params_from_numpy`: float32 host copies."""
    return [{k: layer[k].detach().cpu().numpy().copy() for k in ("w", "b")}
            for layer in params]


def forward(params: Sequence[dict], x01: torch.Tensor) -> torch.Tensor:
    """x01: float[..., n_in] in {0,1}.  Returns (scaled) real logits.

    Pre-activations are scaled by 1/sqrt(fan_in) *after* the bias so the STE
    hard-tanh window sees unit-variance inputs; sign((W.x+b)/c) == sign(W.x+b)
    for c > 0, so the binary behaviour — and the SNN conversion — is
    unaffected.
    """
    h = x01.to(torch.float32)
    for i, layer in enumerate(params):
        wb = ste_sign(layer["w"])
        z = (h @ wb + layer["b"]) * _inv_sqrt(layer["w"].shape[0])
        if i == len(params) - 1:
            return z
        h = ste_sign(z)          # hidden activations in {-1,+1}
    raise ValueError("a BNN needs at least one layer")


def hidden_activations(params: Sequence[dict],
                       x01: torch.Tensor) -> list[torch.Tensor]:
    """Exact (non-STE) hidden ±1 activations, for conversion checks."""
    h = x01.to(torch.float32)
    acts = []
    for layer in params[:-1]:
        h = sign_pm1(h @ sign_pm1(layer["w"]) + layer["b"])
        acts.append(h)
    return acts


def loss_fn(params, x01, labels) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean softmax cross-entropy, logits)."""
    logits = forward(params, x01)
    nll = -F.log_softmax(logits, dim=-1).gather(
        1, labels.long()[:, None]).mean()
    return nll, logits


def init_opt_state(params) -> tuple[list[dict], list[dict], int]:
    """Adam moments (zeros like the params) and the step count."""
    zeros = [{k: torch.zeros_like(v) for k, v in layer.items()}
             for layer in params]
    return zeros, [{k: torch.zeros_like(v) for k, v in layer.items()}
                   for layer in params], 0


def grads(params, x01, labels):
    """(loss, logits, gradients like ``params``) of one batch: the STE
    gradients, ``jax.value_and_grad(loss_fn)``'s counterpart."""
    leaves = [{k: v.detach().requires_grad_(True) for k, v in layer.items()}
              for layer in params]
    flat = [t for layer in leaves for t in layer.values()]
    with torch.enable_grad():
        loss, logits = loss_fn(leaves, x01, labels)
        g = iter(torch.autograd.grad(loss, flat))
    return (loss.detach(), logits.detach(),
            [{k: next(g) for k in layer} for layer in leaves])


def adam_update(params, opt_state, grads_, lr: float):
    """One Adam step of ``params`` along ``grads_``, then the latent clip.
    The bias corrections are float32, as the reference's are.  Returns
    (params, opt_state)."""
    m, v, t = opt_state
    t = t + 1
    one = np.float32(1.0)
    c1 = one - np.float32(ADAM_B1) ** t
    c2 = one - np.float32(ADAM_B2) ** t
    new_p, new_m, new_v = [], [], []
    for p_l, m_l, v_l, g_l in zip(params, m, v, grads_):
        pl, ml, vl = {}, {}, {}
        for k in p_l:
            ml[k] = ADAM_B1 * m_l[k] + (1 - ADAM_B1) * g_l[k]
            vl[k] = ADAM_B2 * v_l[k] + (1 - ADAM_B2) * g_l[k] * g_l[k]
            step = lr * (ml[k] / c1) / (torch.sqrt(vl[k] / c2) + ADAM_EPS)
            pl[k] = torch.clamp(p_l[k] - step, -LATENT_CLIP, LATENT_CLIP)
        new_p.append(pl)
        new_m.append(ml)
        new_v.append(vl)
    return new_p, (new_m, new_v, t)


def train_step(params, opt_state, x01, labels, lr: float):
    """One Adam step on one batch; a bespoke Adam, as the reference has.
    Returns (params, opt_state, loss, batch accuracy)."""
    loss, logits, g = grads(params, x01, labels)
    params, opt_state = adam_update(params, opt_state, g, lr)
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return params, opt_state, loss, acc


def fit(key: torch.Tensor, topology: Sequence[int], x01, labels, *,
        steps: int = 300, batch: int = 128, lr: float = 3e-3,
        device="cuda"):
    """Train a BNN on ``device``; returns (params, final batch accuracy).

    Each step draws ``batch`` sample indices, with replacement, from the
    key's bits (``prng.bits`` mod n)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x01, dtype=torch.float32, device=dev)
    y = torch.as_tensor(labels, device=dev).long()
    key = key.to(dev)
    params = init_params(key, topology, device=dev)
    opt = init_opt_state(params)
    n = x.shape[0]
    acc = torch.zeros(())
    for _ in range(steps):
        key, sub = prng.split(key)
        idx = prng.bits(sub, (batch,)) % n
        params, opt, _, acc = train_step(params, opt, x[idx], y[idx], lr)
    return params, float(acc)
