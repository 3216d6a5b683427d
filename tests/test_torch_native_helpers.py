"""The port's small reference helpers on the CPU: ``native.available`` and
``native.nearest_centroid_batch`` (the same ``native/clustering.cpp`` in
both packages, held bit for bit on the same seeded numpy inputs and
against a float64 numpy argmin), ``ops._mm.mm_fast`` and
``ops.laplacian.SPARSIFY_KEEP_FRACTION``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu import native as jnative
from matternet_rs_tpu.ops import _mm as jmm
from matternet_rs_tpu.ops import laplacian as jlap

from matternet_rs_tpu_torch import native as tnative
from matternet_rs_tpu_torch.ops import _mm as tmm
from matternet_rs_tpu_torch.ops import laplacian as tlap


def _points(n, f, c, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f)).astype(np.float32)
    C = rng.standard_normal((c, f))                       # float64, as the scan keeps them
    return X, C


def test_native_available_matches_the_reference():
    assert tnative.available() == jnative.available()


@pytest.mark.parametrize("n,f,c", [(1, 1, 1), (500, 16, 7), (257, 130, 64), (1000, 3, 200)])
def test_nearest_centroid_batch_matches_the_reference_bit_for_bit(n, f, c):
    if not (tnative.available() and jnative.available()):
        pytest.skip("g++ cannot build the clustering library here")
    X, C = _points(n, f, c, seed=n + f + c)
    idx, d2 = tnative.nearest_centroid_batch(X, C)
    ridx, rd2 = jnative.nearest_centroid_batch(X, C)
    assert idx.dtype == np.int64 and d2.dtype == np.float64
    assert np.array_equal(idx, ridx)
    assert np.array_equal(d2.view(np.int64), rd2.view(np.int64))


@pytest.mark.parametrize("n,f,c", [(500, 16, 7), (300, 768, 40)])
def test_nearest_centroid_batch_is_the_float64_argmin(n, f, c):
    if not tnative.available():
        pytest.skip("g++ cannot build the clustering library here")
    X, C = _points(n, f, c, seed=2 * n + c)
    idx, d2 = tnative.nearest_centroid_batch(X, C)
    full = ((X.astype(np.float64)[:, None, :] - C[None]) ** 2).sum(axis=2)
    assert np.array_equal(idx, np.argmin(full, axis=1))
    np.testing.assert_allclose(d2, full.min(axis=1), rtol=1e-12)   # sums in another order


def test_nearest_centroid_batch_takes_the_first_of_equal_centroids():
    if not tnative.available():
        pytest.skip("g++ cannot build the clustering library here")
    X, C = _points(50, 8, 3, seed=3)
    idx, _ = tnative.nearest_centroid_batch(X, np.concatenate([C, C]))
    assert idx.max() < 3


def test_nearest_centroid_batch_is_none_without_the_library(monkeypatch):
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    assert tnative.available() is False
    assert tnative.nearest_centroid_batch(*_points(4, 2, 2, seed=0)) is None


@pytest.mark.parametrize("m,k,n", [(16, 8, 4), (33, 130, 17)])
def test_mm_fast_is_mm_bf16_within_bf16_error_of_mm(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    fast = tmm.mm_fast(ta, tb)
    assert fast.dtype == torch.float32
    assert torch.equal(fast, tmm.mm_bf16(ta, tb))
    exact = tmm.mm(ta, tb).numpy()
    # Each product's operands are rounded to bf16 (relative error 2^-8 each).
    bound = 2 * 2.0 ** -8 * (np.abs(a) @ np.abs(b)) + 1e-6
    assert np.all(np.abs(fast.numpy() - exact) <= bound)
    ref = np.asarray(jmm.mm_fast(jnp.asarray(a), jnp.asarray(b)))
    assert np.all(np.abs(fast.numpy() - ref) <= 2 * bound)


def test_sparsify_keep_fraction_is_the_reference_constant():
    assert tlap.SPARSIFY_KEEP_FRACTION == jlap.SPARSIFY_KEEP_FRACTION == 0.5
