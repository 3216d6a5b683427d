"""``matternet_rs_tpu_torch.prng`` against ``jax.random`` in the same
process: keys, ``split``, ``random_bits``, ``uniform`` and ``randint`` bit
for bit for seeds 0, 42, 2³¹−1, 2³²+5 and −1 at shapes (), (7,), (1000,)
and (768, 384); ``normal`` within 4 ulp on every entry; ``choice(p=…)``
picks.

``normal`` measured against ``jax.random.normal`` (jax 0.9.0, CPU): at
most 3 ulp on every entry, 99.05–99.07% of entries bit-equal at
(768, 384) for these seeds and 99.06% of 4.2M draws at (2048, 2048)
(seeds 7 and 123); the rest is XLA's own ``log1p`` and fused steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from matternet_rs_tpu_torch import prng

SEEDS = [0, 42, 2**31 - 1, 2**32 + 5, -1]
SHAPES = [(), (7,), (1000,), (768, 384)]
NORMAL_ULP = 4


def _ulp_gap(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bit_for_bit(seed):
    key = jax.random.PRNGKey(seed)
    pk = prng.PRNGKey(seed)
    assert pk.dtype == np.uint32 and np.array_equal(np.asarray(key), pk)
    for num in (2, 3, 5):
        assert np.array_equal(np.asarray(jax.random.split(key, num)), prng.split(pk, num))
    # A chain of splits, as k-means++ walks it.
    k, p = key, pk
    for _ in range(6):
        k, sub = jax.random.split(k)
        p, psub = prng.split(p)
        assert np.array_equal(np.asarray(sub), psub)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_randint_bit_for_bit(seed, shape):
    key, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert np.array_equal(np.asarray(jax.random.bits(key, shape, jnp.uint32)),
                          prng.random_bits(pk, shape))
    u = np.asarray(jax.random.uniform(key, shape))
    assert np.array_equal(u.view(np.uint32), prng.uniform(pk, shape).view(np.uint32))
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=1.0))
    assert np.array_equal(u.view(np.uint32), prng.uniform(pk, shape, lo, 1.0).view(np.uint32))
    for lo_i, hi_i in ((0, 10), (0, 1000), (-5, 3), (0, 70_000), (0, 2**31 - 1),
                       (-(2**31), 2**31 - 1), (9, 2)):
        ref = np.asarray(jax.random.randint(key, shape, lo_i, hi_i))
        got = prng.randint(pk, shape, lo_i, hi_i)
        assert got.dtype == ref.dtype == np.int32 and np.array_equal(ref, got), (lo_i, hi_i)


def test_randint_rejects_bounds_outside_int32():
    with pytest.raises(OverflowError):
        prng.randint(prng.PRNGKey(0), (), 0, 2**31)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_the_ulp_bound(seed, shape):
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.PRNGKey(seed), shape)
    assert got.dtype == np.float32 and got.shape == ref.shape
    gap = _ulp_gap(ref, got)
    assert gap.max(initial=0) <= NORMAL_ULP
    if gap.size >= 1000:
        assert np.mean(gap == 0) >= 0.98


def test_erf_inv_matches_xla_and_maps_the_ends():
    x = np.linspace(-0.9999, 0.9999, 20001, dtype=np.float32)
    gap = _ulp_gap(jax.lax.erf_inv(jnp.asarray(x)), prng.erf_inv32(x))
    assert gap.max() <= NORMAL_ULP
    ends = prng.erf_inv32(np.array([-1.0, 1.0, 0.0], np.float32))
    assert ends[0] == -np.inf and ends[1] == np.inf and ends[2] == 0.0


@pytest.mark.parametrize("seed", [0, 3, 42])
def test_choice_with_p_picks_as_jax(seed):
    """Picks equal, or the draw lay within the cumulative sums' float32
    reach of the boundary between the two picks."""
    rng = np.random.default_rng(seed)
    n = 300
    p = rng.random(n).astype(np.float32) ** 3
    p /= p.sum()
    key = jax.random.PRNGKey(seed)
    for i in range(40):
        key, sub = jax.random.split(key)
        ref = int(jax.random.choice(sub, n, p=jnp.asarray(p)))
        got = int(prng.choice(np.asarray(sub), n, p=p))
        if ref != got:
            cum = np.cumsum(p.astype(np.float64))
            r = cum[-1] * (1.0 - float(prng.uniform(np.asarray(sub), ())))
            edge = cum[min(ref, got)]
            assert abs(r - edge) <= 4 * n * np.finfo(np.float32).eps, (i, ref, got)
    # Without p: randint.
    assert np.array_equal(np.asarray(jax.random.choice(key, n, (5,))), prng.choice(np.asarray(key), n, (5,)))
