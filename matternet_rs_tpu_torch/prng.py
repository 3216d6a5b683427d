"""Counter-based random streams: ``jax.random``'s threefry2x32, in numpy.

The reference draws its JL projection matrix, its k-means++ seeds and
LOBPCG's start block from ``jax.random`` keys. A stored index keeps only
the projection's seed, so the port must regenerate the same stream. This
module is that stream on numpy ``uint32``, on the host:

* :func:`PRNGKey` — the key of an integer seed as JAX makes it with 64-bit
  types off (its default): the seed wraps to 32 bits, the high word is 0;
* :func:`split`, :func:`random_bits` — threefry2x32 (20 rounds, rotations
  13/15/26/6 and 17/29/16/24) over JAX's partitionable counter layout (the
  flat index as a (high, low) word pair; 32-bit draws are ``bits1 ^
  bits2``);
* :func:`uniform`, :func:`randint` — JAX's mantissa fill and its two-draw
  span reduction, bit for bit;
* :func:`normal` — ``√2 · erf_inv(u)`` with a float32 mirror of XLA's
  ``ErfInv32`` polynomial. XLA's ``log1p`` and its fused Horner steps are
  not reproduced exactly, so a few entries differ by an ulp or two
  (``tests/test_torch_prng.py`` states the measured bound);
* :func:`choice` with ``p`` — cumulative sum, a uniform, a left
  ``searchsorted``, as ``jax.random.choice(..., p=p)`` draws with
  replacement.

Keys, scalars and small matrices are made here; device tensors take the
results.
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _threefry2x32(k0, k1, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 hash of counter words ``(x0, x1)`` under key words
    ``(k0, k1)`` (scalars, or arrays broadcasting against the counters)."""
    k0 = np.asarray(k0, np.uint32)
    k1 = np.asarray(k1, np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The flat indices ``0..n-1`` as (high, low) 32-bit words."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), i.astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: ``[0, seed mod 2³²]`` as ``uint32``
    (JAX with 64-bit types off turns the seed into a 32-bit integer
    first, so a seed of 2³² + 5 gives the key of 5 and −1 that of
    2³² − 1)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``[num, 2]`` ``uint32`` keys."""
    key = np.asarray(key, np.uint32)
    hi, lo = _counters(num)
    b1, b2 = _threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], axis=-1)


def random_bits(key, shape=()) -> np.ndarray:
    """32 random bits per element of ``shape`` (``jax.random.bits``)."""
    key = np.asarray(key, np.uint32)
    shape = tuple(shape)
    hi, lo = _counters(math.prod(shape))
    b1, b2 = _threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def _unit_floats(bits: np.ndarray) -> np.ndarray:
    """Random mantissa under exponent 0: float32 in [0, 1)."""
    fb = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    return fb.view(np.float32) - np.float32(1.0)


def uniform(key, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: values in ``[minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = _unit_floats(random_bits(key, shape))
    return np.maximum(lo, floats * (hi - lo) + lo).astype(np.float32)


def randint(key, shape=(), minval: int = 0, maxval: int = 1) -> np.ndarray:
    """``jax.random.randint`` in int32: two draws of 32 bits from the two
    halves of ``split(key)``, reduced into ``[minval, maxval)`` by JAX's
    ``(hi % span) · ((2¹⁶ % span)² % span) + lo % span``, all in wrapping
    32-bit arithmetic."""
    i32 = np.iinfo(np.int32)
    lo_v, hi_v = int(minval), int(maxval)
    if not (i32.min <= lo_v <= i32.max and i32.min <= hi_v <= i32.max):
        raise OverflowError(f"randint bounds [{lo_v}, {hi_v}) leave the int32 range")
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = 1 if hi_v <= lo_v else hi_v - lo_v
    # JAX squares 2¹⁶ % span in 32 bits too: from spans above 2¹⁶ the
    # square wraps to 0, and so does the multiplier.
    mult = ((2 ** 16 % span) ** 2 & 0xFFFFFFFF) % span
    span_u = np.uint32(span)
    offset = ((higher % span_u) * np.uint32(mult) + lower % span_u) % span_u
    return ((lo_v + offset.astype(np.int64)) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


_ERFINV_SMALL = np.array(
    [2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
     -0.00125372503, -0.00417768164, 0.246640727, 1.50140941], np.float32)
_ERFINV_LARGE = np.array(
    [-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
     -0.0076224613, 0.00943887047, 1.00167406, 2.83297682], np.float32)


def erf_inv32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv``: ``w = −log1p(−x²)``; below 5 a degree-8
    polynomial in ``w − 2.5``, else one in ``√w − 3``; times ``x``; ±1 map
    to ±inf. Each Horner step is rounded once (a fused multiply-add:
    the product of two float32 values is exact in float64), and
    ``log1p`` is float64's, rounded to float32."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore"):                    # x = ±1: w = inf
        w = (-np.log1p((x * -x).astype(np.float64))).astype(np.float32)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    wd = w.astype(np.float64)
    p = np.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0]).astype(np.float32)
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = np.where(small, cs, cl).astype(np.float64)
        p = (c + p.astype(np.float64) * wd).astype(np.float32)
    out = p * x
    return np.where(np.abs(x) == np.float32(1.0), x * np.float32(np.inf), out).astype(np.float32)


def normal(key, shape=()) -> np.ndarray:
    """``jax.random.normal`` in float32: ``√2 · erf_inv(u)`` with ``u``
    uniform in ``[nextafter(−1, 0), 1)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, np.float32(1.0))
    return (np.float32(math.sqrt(2.0)) * erf_inv32(u)).astype(np.float32)


def choice(key, n: int, shape=(), p=None) -> np.ndarray:
    """``jax.random.choice(key, n, shape, replace=True, p=p)``: with ``p``,
    ``searchsorted(cumsum(p), cumsum(p)[-1] · (1 − u))`` (left side); without,
    :func:`randint`. Returns int32 indices."""
    if p is None:
        return randint(key, shape, 0, n)
    p = np.asarray(p, np.float32)
    if p.shape != (n,):
        raise ValueError(f"p must have shape ({n},), got {p.shape}")
    cum = np.cumsum(p, dtype=np.float32)
    r = cum[-1] * (np.float32(1.0) - uniform(key, shape))
    return np.searchsorted(cum, r, side="left").astype(np.int32)
