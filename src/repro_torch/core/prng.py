"""Counter-based random numbers, bit for bit those of ``jax.random``.

The reference draws every online-learning uniform, every shuffle and its
test weights with ``jax.random`` under the threefry2x32 generator with
``jax_threefry_partitionable`` on (the default of the JAX it runs on).  This
module computes the same bits in PyTorch, so the port's trainer makes the
same draws as the reference under the same key and the two give the same
weights, accuracies and update counts.

A key is a ``torch.int64`` tensor ``[..., 2]`` holding two uint32 words
(``PRNGKey(s)`` is ``(0, s mod 2^32)``, as JAX makes it with 64-bit types
off).  CPU torch has no uint32 shift, so every word lives in an int64 and is
masked to 32 bits after each add, shift and rotate.  Every function takes
any number of keys at once (leading dims broadcast) and runs on the keys'
device, CPU or CUDA alike:

* ``threefry2x32(k, (x0, x1))``: the 20-round Threefry-2x32 block cipher
  (rotations 13,15,26,6 / 17,29,16,24, key injection after every 4 rounds);
* ``fold_in(k, d) = threefry(k, (0, d))``; ``split(k, n)[j] = threefry(k, (0, j))``;
* ``bits(k, shape)[i] = x0 ^ x1`` of ``threefry(k, (0, i))``, i the flat index;
* ``uniform = bitcast_f32((bits >> 9) | 0x3f800000) - 1`` in [0, 1);
* ``bernoulli(k, p) = uniform < p`` (p rounded to float32, as JAX does);
* ``permutation(k, n)``: ``ceil(3 ln n / ln(2^32 - 1))`` rounds of
  ``k, sub = split(k)`` and a stable sort of the order by ``bits(sub, (n,))``.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x) -> torch.Tensor:
    return x & MASK32


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (JAX's name)
    """The key of ``jax.random.PRNGKey(seed)``: int64[2] = (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return _u32((x << r) | (x >> (32 - r)))


def threefry2x32(key: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words ``(x0, x1)`` under ``key[..., 2]``.

    ``x0``/``x1`` are int64 tensors of uint32 values that broadcast against
    ``key[..., 0]``.  Returns the two output words, same broadcast shape."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = _u32(x0 + ks[0])
    x1 = _u32(x1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = _u32(x0 + x1)
            x1 = _rotl(x1, r) ^ x0
        x0 = _u32(x0 + ks[(i + 1) % 3])
        x1 = _u32(x1 + ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def _counter(data, device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return _u32(data.to(device=device, dtype=torch.int64))
    return _u32(torch.as_tensor(np.asarray(data).astype(np.int64),
                                device=device))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key per ``data`` (an int or an integer
    tensor, taken mod 2^32, broadcast against the keys' leading dims)."""
    d = _counter(data, key.device)
    y0, y1 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., num, 2]`` new keys."""
    j = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., None, :], torch.zeros_like(j), j)
    return torch.stack((y0, y1), -1)


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): int64 ``[..., *shape]`` of uint32 values."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    lead = key.shape[:-1]
    k = key.reshape(lead + (1,) * len(shape) + (2,))
    i = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    y0, y1 = threefry2x32(k, torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform`` (float32, [0, 1)): ``[..., *shape]``."""
    b = (bits(key, shape) >> 9) | 0x3F800000
    return b.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli``: bool ``[..., *shape]``, True where the
    uniform is below ``p`` rounded to float32."""
    return uniform(key, shape) < float(np.float32(p))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for one key: int64[n]."""
    if key.shape != (2,):
        raise ValueError(f"permutation takes one key [2], got {tuple(key.shape)}")
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x
