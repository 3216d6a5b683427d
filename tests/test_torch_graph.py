"""Port vs reference: the dense adjacency and Laplacian build (ties
included) and the incremental clustering scan (bit-identical centroids and
assignments)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu import clustering as jclus
from matternet_rs_tpu import sampling as jsamp
from matternet_rs_tpu.graph import GraphParams as JGraphParams
from matternet_rs_tpu.ops import laplacian as jlap

from matternet_rs_tpu_torch import clustering as tclus
from matternet_rs_tpu_torch import native as tnative
from matternet_rs_tpu_torch import sampling as tsamp
from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.ops import laplacian as tlap
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset


def _nodes(n, m, seed, ties=False):
    X = np.random.default_rng(seed).normal(size=(n, m)).astype(np.float32)
    if ties:
        X[10:20] = X[0]          # identical rows: exactly tied distances
        X[25] = 2.0 * X[1]       # same direction: cosine tie with row 1
    return X


PARAMS = [
    dict(eps=0.9, k=5, topk=5),
    dict(eps=1.0, k=6, topk=16),                     # mean degree > 10: sparsifies
    dict(eps=0.7, k=4, topk=8, p=2.0, sigma=0.4, normalise=True),
]
# A non-integer p is left out of the tied cases on purpose: for identical
# profiles the rectified distance may round to -1.2e-7, (d/σ)^p is then NaN
# and the edge drops, in both packages, wherever the rounding falls
# (ROADMAP.md Queue 3).
CASES = [(p, ties) for p in PARAMS for ties in (False, True)] + [
    (dict(eps=0.7, k=4, topk=8, p=1.5, sigma=0.4, normalise=True), False),
]


@pytest.mark.parametrize("params,ties", CASES)
def test_adjacency_matches_reference(params, ties):
    X = _nodes(48, 30, seed=len(params), ties=ties)
    ref = np.asarray(jlap.build_adjacency(jnp.asarray(X), JGraphParams(**params)))
    got = tlap.build_adjacency(torch.from_numpy(X), GraphParams(**params)).numpy()
    assert np.array_equal(ref > 0, got > 0)          # same edge set
    assert np.allclose(ref, got, atol=1e-6)


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_laplacian_matches_reference(normalized, ties):
    X = _nodes(40, 25, seed=3, ties=ties)
    p = dict(eps=0.95, k=6, topk=6, sparsity_check=False)
    ref = jlap.build_laplacian_matrix(jnp.asarray(X), JGraphParams(**p), normalized=normalized)
    got = tlap.build_laplacian_matrix(torch.from_numpy(X), GraphParams(**p), normalized=normalized)
    assert np.allclose(np.asarray(ref.matrix), got.matrix.numpy(), atol=1e-6)
    assert got.nnodes == ref.nnodes


def test_laplacian_from_k_cluster_matches_reference():
    C = _nodes(50, 32, seed=4)                       # [C, F] centroids
    p = dict(eps=1.0, k=6, topk=4, sparsity_check=False)
    ref = jlap.build_laplacian_from_k_cluster(jnp.asarray(C), JGraphParams(**p), n_items=1000)
    got = tlap.build_laplacian_from_k_cluster(torch.from_numpy(C), GraphParams(**p), n_items=1000)
    assert got.shape == (32, 32)
    assert np.allclose(np.asarray(ref.matrix), got.matrix.numpy(), atol=1e-6)


def test_sparsity_check_and_ell_size_raise():
    with pytest.raises(ValueError, match="too sparse"):
        tlap.build_laplacian_matrix(
            torch.from_numpy(_nodes(60, 8, seed=5)),
            GraphParams(eps=1e-4, k=2, topk=2, sparsity_check=True),
        )
    # From DIRECT_ELL_N nodes the build no longer refuses: it returns an
    # ELL-backed graph and never forms [n, n].
    nodes = np.random.default_rng(5).normal(size=(tlap.DIRECT_ELL_N, 4)).astype(np.float32)
    gl = tlap.build_laplacian_matrix(
        torch.from_numpy(nodes), GraphParams(eps=0.2, k=3, topk=3, sparsity_check=False))
    assert gl.is_ell_backed and gl.matrix is None
    assert gl.shape == (tlap.DIRECT_ELL_N, tlap.DIRECT_ELL_N)
    assert gl.ell().max_degree < 64
    assert float(gl.multiply_vector(torch.ones(tlap.DIRECT_ELL_N)).abs().max()) <= 1e-5


def _clustering_data():
    return make_energy_test_dataset(6000, 16, seed=9).astype(np.float32)


@pytest.mark.parametrize("rate", [None, 0.6])
def test_incremental_clustering_bit_identical(rate):
    X = _clustering_data()
    js = None if rate is None else jsamp.make_sampler("simple", rate, seed=4)
    ts = None if rate is None else tsamp.make_sampler("simple", rate, seed=4)
    ref = jclus.incremental_clustering(X, max_clusters=40, radius=3.0, sampler=js)
    got = tclus.incremental_clustering(X, max_clusters=40, radius=3.0, sampler=ts)
    assert tnative.get_lib() is not None
    assert np.array_equal(ref.centroids, got.centroids)
    assert np.array_equal(ref.assignments, got.assignments)
    assert np.array_equal(ref.sizes, got.sizes)
    if rate is not None:
        assert js.get_stats() == ts.get_stats()


def test_sequential_scan_bit_identical_with_adaptive_sampler():
    """Density-adaptive sampling reads live state: both packages take the
    Python sequential scan."""
    X = _clustering_data()[:1500]
    ref = jclus.incremental_clustering(
        X, 30, 3.0, sampler=jsamp.make_sampler("density_adaptive", 0.5, seed=1)
    )
    got = tclus.incremental_clustering(
        X, 30, 3.0, sampler=tsamp.make_sampler("density_adaptive", 0.5, seed=1)
    )
    assert np.array_equal(ref.centroids, got.centroids)
    assert np.array_equal(ref.assignments, got.assignments)


def test_python_scan_equals_native_scan():
    X = _clustering_data()[:2000]
    native = tclus.incremental_clustering(X, 25, 3.0)
    python = tclus._incremental_sequential(X, 25, 3.0, None)
    assert np.array_equal(native.assignments, python.assignments)
    assert np.allclose(native.centroids, python.centroids, atol=1e-5)
