"""The JL projection (``matternet_rs_tpu_torch.reduction``) and the builder's
``with_dims_reduction`` against the reference in the same process.

Tolerances: ``compute_jl_dimension`` equal; the projection matrix within
the ulp bound of ``prng.normal`` (4 ulp, ``tests/test_torch_prng.py``);
a projection within 1e-6 of the largest projected entry; λ and its
statistics within 1e-5·max(1, |x|); search ids under the near-tie rule
(``utils/parity.py``).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matternet_rs_tpu import builder as jbuilder
from matternet_rs_tpu import reduction as jred

from matternet_rs_tpu_torch import builder as tbuilder
from matternet_rs_tpu_torch import convert
from matternet_rs_tpu_torch import core as tcore
from matternet_rs_tpu_torch import reduction as tred
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset
from matternet_rs_tpu_torch.utils.parity import topk_mismatches

K = 10
NORMAL_ULP = 4


def _close(ref, got, tol=1e-5):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return np.all(np.abs(ref - got) <= tol * np.maximum(1.0, np.abs(ref)))


@pytest.mark.parametrize("f", [8, 31, 32, 200, 768, 2048, 2049, 4096, 20_000, 100_000])
def test_compute_jl_dimension_equal(f):
    """F below 32, from 32 to 2048, and beyond at every buffer factor
    (compression under 10, under 100, from 100)."""
    for n, eps in itertools.product((1, 2, 16, 111, 10_000, 1_000_000), (0.1, 0.3, 0.5, 0.9)):
        assert tred.compute_jl_dimension(n, f, eps) == jred.compute_jl_dimension(n, f, eps), (n, f, eps)


def test_compute_jl_dimension_reaches_every_buffer_factor():
    factors = set()
    for f, n, eps in itertools.product((2500, 20_000, 200_000), (2, 100, 10_000), (0.1, 0.5, 0.9)):
        bound = int(np.ceil(8.0 * np.log(n) / eps ** 2))
        ratio = f / bound
        factors.add(1.2 if ratio < 10 else 1.5 if ratio < 100 else 2.0)
        assert tred.compute_jl_dimension(n, f, eps) == jred.compute_jl_dimension(n, f, eps)
    assert factors == {1.2, 1.5, 2.0}


@pytest.mark.parametrize("seed,f,r", [(42, 768, 384), (5, 200, 100), (0, 64, 33), (2**32 + 5, 40, 32),
                                    (42, 1536, 491)])
def test_projection_matrix_within_the_ulp_bound(seed, f, r):
    ref = np.asarray(jred.ImplicitProjection(f, r, seed).matrix())
    got = tred.ImplicitProjection(f, r, seed).matrix("cpu").numpy()
    assert got.shape == (f, r) and got.dtype == np.float32
    gap = np.abs(ref.view(np.int32).astype(np.int64) - got.view(np.int32).astype(np.int64))
    assert gap.max() <= NORMAL_ULP
    assert np.array_equal(got, tred.projection_matrix_host(seed, f, r))


def test_project_within_1e6_and_cached():
    X = np.random.default_rng(4).normal(size=(2000, 768)).astype(np.float32)
    jp, tp = jred.ImplicitProjection(768, 384, 42), tred.ImplicitProjection(768, 384, 42)
    ref = np.asarray(jred.project_matrix(jnp.asarray(X), jp))
    got = tred.project_matrix(torch.from_numpy(X), tp).numpy()
    assert np.abs(ref - got).max() <= 1e-6 * np.abs(ref).max()
    assert tp.matrix("cpu") is tp.matrix("cpu")
    # An array goes to the device asked for.
    assert torch.equal(tp.project(X, device="cpu"), torch.from_numpy(got))


def _configure(b):
    return (b.with_lambda_graph(1.0, 6).with_sparsity_check(False)
            .with_cluster_params(max_clusters=16, radius=30.0).with_seed(5)
            .with_sampling(None).with_dims_reduction(True))


@pytest.fixture(scope="module")
def jl_built():
    X = make_energy_test_dataset(3000, 200, seed=21).astype(np.float32)
    ja, jgl = _configure(jbuilder.ArrowSpaceBuilder()).build(X)
    ta, tgl = _configure(tbuilder.ArrowSpaceBuilder(device="cpu")).build(X)
    Q = X[np.random.default_rng(3).choice(len(X), 16, replace=False)]
    return X, Q, ja, jgl, ta, tgl


def test_dims_reduction_build_matches_reference(jl_built):
    X, Q, ja, jgl, ta, tgl = jl_built
    assert ta.reduced_dim == ja.reduced_dim == 100
    assert (ta.projection.original_dim, ta.projection.reduced_dim, ta.projection.seed) == (
        ja.projection.original_dim, ja.projection.reduced_dim, ja.projection.seed)
    assert tuple(tgl.matrix.shape) == (100, 100) and ta.data.shape == (3000, 200)
    assert np.allclose(np.asarray(jgl.matrix), tgl.matrix.numpy(), atol=1e-5)
    for s in ("min_lambdas", "max_lambdas", "range_lambdas"):
        assert _close(getattr(ja, s), getattr(ta, s)), s
    assert _close(np.asarray(ja.lambdas), ta.lambdas.numpy())


def test_dims_reduction_search_matches_reference(jl_built):
    """λ of the projected queries, cosine over the 200-wide rows."""
    X, Q, ja, jgl, ta, tgl = jl_built
    ref_idx, ref_sc, ref_raw = ja.search_batch(Q, jgl, K + 1, return_raw=True)
    idx, sc, raw = ta.search_batch(Q, tgl, K, return_raw=True)
    assert _close(ref_raw, raw)
    assert not topk_mismatches(ref_idx, ref_sc, idx, sc)
    assert _close(ja.prepare_query_item(Q[0], jgl), ta.prepare_query_item(Q[0], tgl))
    assert np.allclose(np.asarray(ja.project_query(Q[1])), ta.project_query(Q[1]).numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="original dimension"):
        ta.project_query(Q[1][:50])


def test_projection_carried_by_convert(jl_built):
    """A reference-built JL index carried across as arrays searches alike."""
    X, Q, ja, jgl, _, _ = jl_built
    p = ja.projection
    ta, tgl = convert.arrowspace_from_arrays(
        np.asarray(ja.data), np.asarray(ja.lambdas), np.asarray(jgl.matrix),
        min_lambdas=ja.min_lambdas, max_lambdas=ja.max_lambdas, range_lambdas=ja.range_lambdas,
        graph_params=vars(jgl.graph_params), projection=(p.original_dim, p.reduced_dim, p.seed),
        device="cpu",
    )
    assert ta.reduced_dim == 100
    ref_idx, ref_sc = ja.search_batch(Q, jgl, K + 1)
    idx, sc = ta.search_batch(Q, tgl, K)
    assert not topk_mismatches(ref_idx, ref_sc, idx, sc)


def test_query_width_is_checked_with_a_projection(jl_built):
    X, Q, _, _, ta, tgl = jl_built
    with pytest.raises(ValueError, match="doesn't match"):
        ta.search_batch(Q[:, :150], tgl, K)
    with pytest.raises(ValueError, match="doesn't match"):
        ta.prepare_query_item(Q[0, :150], tgl)
    # The reduced width itself is a valid λ input.
    assert np.isfinite(ta.prepare_query_item(ta.project_query(Q[0]).numpy(), tgl))


def test_centroids_are_not_projected_below_their_count():
    """No projection at F ≤ 64, nor where the reduced width (F // 2 = 40
    here) would not exceed the centroid count (60)."""
    for f, clusters in ((64, 16), (80, 60)):
        X = make_energy_test_dataset(600, f, seed=2).astype(np.float32)
        ja, _ = _configure(jbuilder.ArrowSpaceBuilder()).with_cluster_params(max_clusters=clusters).build(X)
        ta, _ = _configure(tbuilder.ArrowSpaceBuilder(device="cpu")).with_cluster_params(
            max_clusters=clusters).build(X)
        assert ta.n_clusters == ja.n_clusters
        assert ta.projection is None and ja.projection is None and ta.reduced_dim is None


def test_start_clustering_dim_reduce_matches_reference():
    """Early JL at F > 1000: every row projected first, the clustering in
    the reduced space, the original rows kept."""
    X = np.random.default_rng(6).normal(size=(400, 1200)).astype(np.float32)
    X[:200] += 3.0
    jb = (jbuilder.ArrowSpaceBuilder().with_cluster_params(max_clusters=8, radius=4000.0)
          .with_seed(3).with_sampling(None).with_dims_reduction(True))
    tb = (tbuilder.ArrowSpaceBuilder(device="cpu").with_cluster_params(max_clusters=8, radius=4000.0)
          .with_seed(3).with_sampling(None).with_dims_reduction(True))
    ja, jc = jb.start_clustering_dim_reduce(X)
    ta, tc = tb.start_clustering_dim_reduce(X)
    assert ta.reduced_dim == ja.reduced_dim == 533          # jl_dim(400, 1200, 0.3)
    assert ta.data.shape == (400, 1200) and tc.shape == jc.shape
    assert np.array_equal(ta.cluster_assignments, ja.cluster_assignments)
    assert np.allclose(np.asarray(jc), tc, atol=1e-4)
    # Below 1000 features nothing is projected.
    ta2, tc2 = tb.start_clustering_dim_reduce(X[:, :900])
    assert ta2.projection is None and tc2.shape[1] == 900


def test_empty_with_projection_and_drop_data():
    cfg = {"projection_original_dim": 200, "reduced_dim": 100, "projection_seed": 5}
    sp = tcore.ArrowSpace.empty_with_projection(cfg, 30, 200, device="cpu")
    assert sp.nitems == 30 and sp.data.shape == (0, 200)
    assert (sp.projection.original_dim, sp.projection.reduced_dim, sp.projection.seed) == (200, 100, 5)
    with pytest.raises(ValueError, match="extra dim reduction"):
        tcore.ArrowSpace.empty_with_projection({"extra_reduced_dim": True}, 3, 4, device="cpu")
    plain = tcore.ArrowSpace.empty_with_projection({}, 3, 4, device="cpu")
    assert plain.projection is None and plain.reduced_dim is None
