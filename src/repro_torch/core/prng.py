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
* ``uniform = bitcast_f32((bits >> 9) | 0x3f800000) - 1`` in [0, 1), and
  with bounds ``max(lo, fma(u, hi - lo, lo))`` in float32;
* ``normal = sqrt(2) * erf_inv(uniform(k, lo=nextafter(-1, 0), hi=1))``, with
  ``erf_inv`` the single-precision polynomial XLA lowers ``lax.erf_inv`` to
  (Giles), in float32 torch ops; not bit for bit: ``torch.log1p`` is not
  XLA's, so about one draw in a hundred sits a few ulp from JAX's
  (``tests/test_torch_faults.py`` states the bound);
* ``bernoulli(k, p) = uniform < p`` (p rounded to float32, as JAX does);
* ``randint(k, shape, lo, hi)`` (int32): ``k1, k2 = split(k)``, two words
  ``bits(k1)``, ``bits(k2)`` folded into ``[lo, hi)`` by uint32 remainders
  (``span = uint32(hi - lo)``, 1 where ``hi <= lo``; every product and sum
  wraps at 32 bits);
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


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``fma(a, b, c)`` rounded once, as XLA contracts ``a * b + c``
    (``b`` and ``c`` tensors or floats): the product is exact in float64,
    the sum is rounded to odd there (TwoSum and a sticky last bit), then to
    float32; ``kernels/lif_step/ref.py`` states why that is one rounding."""
    def f64(x):   # a float stays a scalar: no copy to the device
        return x.to(torch.float64) if isinstance(x, torch.Tensor) else float(x)

    p = a.to(torch.float64) * f64(b)
    c = f64(c)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    return torch.where((err != 0) & even, torch.nextafter(s, toward),
                       s).to(torch.float32)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``sqrt`` correctly rounded, as XLA's: taken in float64 and
    rounded to float32, which for a float32 input is the correctly rounded
    root.  torch's float32 ``sqrt`` on the CPU is not: about 0.7 % of its
    results are an ulp off, and in some processes a share of a large
    call's elements (a block of indices, so one thread's chunk) came back
    ~1e-4 off, so a draw or a fit differed between runs."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (float32, [minval, maxval)): ``[..., *shape]``.

    The bounds are rounded to float32 and applied as JAX does, in float32:
    ``max(minval, u * (maxval - minval) + minval)``, the scale and shift one
    fused multiply-add (XLA contracts them)."""
    b = (bits(key, shape) >> 9) | 0x3F800000
    u = b.to(torch.int32).view(torch.float32) - 1.0
    if (minval, maxval) == (0.0, 1.0):
        return u                       # the bounds change no bit here
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(fma32(u, float(hi - lo), float(lo)), float(lo))


#: Giles' single-precision erf_inv coefficients, as XLA lowers
#: ``lax.erf_inv`` for float32 (w < 5, and the tail)
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``lax.erf_inv``: ``w = -log1p(-x^2)``, Horner in ``w - 2.5``
    (w < 5) or ``sqrt(w) - 3`` (:func:`sqrt32`) with each step one fused
    multiply-add (as XLA contracts it), times x; +-inf at +-1.  Only
    ``torch.log1p`` differs from XLA's, by an ulp now and then."""
    w = -torch.log1p(x * -x)
    central = w < 5.0
    w = torch.where(central, w - 2.5, sqrt32(w) - 3.0)
    coef = [torch.where(central, np.float32(c), np.float32(t))
            for c, t in zip(_ERFINV_CENTRAL, _ERFINV_TAIL)]
    p = coef[0].expand_as(x)
    for c in coef[1:]:
        p = fma32(p, w, c)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` (float32): ``[..., *shape]``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, float(lo), 1.0)
    return float(np.float32(np.sqrt(2.0))) * erf_inv(u)


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli``: bool ``[..., *shape]``, True where the
    uniform is below ``p`` rounded to float32."""
    return uniform(key, shape) < float(np.float32(p))


I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``uint32(a * b)`` of uint32 values in int64, without overflowing the
    int64 product: ``a``'s 16-bit halves times ``b``."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return _u32(lo + hi)


def randint(key: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint`` for int32: int32 ``[..., *shape]`` in
    ``[minval, maxval)``, bit for bit (jax's ``_randint``).

    ``minval``/``maxval`` are ints or integer tensors that broadcast against
    ``shape``, inside the int32 range (JAX, with 64-bit types off, raises
    ``OverflowError`` outside it; so does this).  Two 32-bit draws a value,
    ``higher`` from ``split(key)[0]`` and ``lower`` from ``split(key)[1]``,
    give ``(higher % span * (2^16 % span)^2 % span + lower % span) % span``
    with ``span = uint32(maxval - minval)`` (1 where ``maxval <= minval``),
    every product and sum wrapping at 32 bits as the reference's uint32
    ``lax.mul`` and ``lax.add`` do; the offset is added to ``minval`` in
    int32."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    # checked where the bounds are (the host for ints: no device sync)
    lo, hi = (torch.as_tensor(v, dtype=torch.int64) for v in (minval, maxval))
    for bound in (lo, hi):
        if bool(((bound < I32_MIN) | (bound > I32_MAX)).any()):
            raise OverflowError(f"randint bounds ({minval}, {maxval}) are "
                                "outside the int32 range")
    lo, hi = lo.to(key.device), hi.to(key.device)
    k = split(key)
    higher, lower = bits(k[..., 0, :], shape), bits(k[..., 1, :], shape)
    span = torch.where(hi <= lo, 1, _u32(hi - lo))
    multiplier = 2**16 % span
    multiplier = _mul32(multiplier, multiplier) % span
    offset = _u32(_mul32(higher % span, multiplier) + lower % span) % span
    # int32 add with wraparound
    return (_u32(lo + offset) ^ 2**31).sub(2**31).to(torch.int32)


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
