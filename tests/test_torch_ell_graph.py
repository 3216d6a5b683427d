"""Port vs reference: the direct ELL graph build (``build_laplacian_ell``,
called directly at a few hundred nodes with a small ``row_tile`` so several
distance strips form) and the ELL-backed ``GraphLaplacian``.

Tolerances: per row the ELL's live (id, weight) pairs are the reference's
as sets, weights and diagonal within 1e-6 (f32 products and sums in another
order than XLA's); the dense form equals the port's own dense build within
1e-6."""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu.graph import GraphParams as JGraphParams
from matternet_rs_tpu.ops import laplacian as jlap

from matternet_rs_tpu_torch.graph import GraphLaplacian, GraphParams
from matternet_rs_tpu_torch.ops import laplacian as tlap

TOL = 1e-6


def _nodes(n, m, seed, ties=False):
    X = np.random.default_rng(seed).normal(size=(n, m)).astype(np.float32)
    if ties:
        X[10:20] = X[0]          # identical profiles: exactly tied distances
        X[25] = 2.0 * X[1]       # same direction: a cosine tie with row 1
    return X


def _row_sets(ids, w):
    ids, w = np.asarray(ids), np.asarray(w)
    return [sorted((int(j), float(x)) for j, x in zip(ri, rw) if x > 0) for ri, rw in zip(ids, w)]


def _assert_same_rows(ref_ids, ref_w, got_ids, got_w):
    assert np.asarray(ref_ids).shape == tuple(got_ids.shape)
    for i, (a, b) in enumerate(zip(_row_sets(ref_ids, ref_w), _row_sets(got_ids, got_w))):
        assert [j for j, _ in a] == [j for j, _ in b], f"row {i}: neighbour ids differ"
        assert np.allclose([x for _, x in a], [x for _, x in b], atol=TOL), f"row {i}"


def _assert_same_ell(ref, got):
    assert got.indices.dtype == torch.int32
    _assert_same_rows(ref.indices, ref.weights, got.indices, got.weights)
    assert np.allclose(np.asarray(ref.diag), got.diag.numpy(), atol=TOL)
    # Empty slots carry −1, as the reference writes them.
    assert np.array_equal(np.asarray(ref.indices) < 0, got.indices.numpy() < 0)


# A non-integer exponent is left out of the tied cases: identical profiles
# can give a rectified distance of −1.2e-7, (d/σ)^p is then NaN and the edge
# drops wherever the rounding falls, in both packages (ROADMAP.md Queue 3).
CASES = [
    (dict(eps=1.0, k=6, topk=4), 300, False),
    (dict(eps=1.0, k=6, topk=4, p=2.0), 300, True),
    (dict(eps=0.9, k=5, topk=5), 257, False),
    (dict(eps=1.0, k=6, topk=16), 200, False),                   # mean degree > 10: sparsifies
    (dict(eps=0.7, k=4, topk=8, p=2.0, sigma=0.4, normalise=True), 220, True),
    (dict(eps=0.7, k=4, topk=8, p=1.5, sigma=0.4, normalise=True), 220, False),
]


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("params,n,ties", CASES)
def test_build_laplacian_ell_matches_reference(params, n, ties, normalized):
    X = _nodes(n, 30, seed=n, ties=ties)
    p = dict(params, sparsity_check=False)
    ref = jlap.build_laplacian_ell(jnp.asarray(X), JGraphParams(**p), normalized=normalized,
                                   row_tile=64)
    got = tlap.build_laplacian_ell(torch.from_numpy(X), GraphParams(**p), normalized=normalized,
                                   row_tile=64)
    assert got.is_ell_backed and got.matrix is None and got.nnodes == ref.nnodes
    _assert_same_ell(ref.ell(), got.ell())
    # ... and it is the port's own dense build, never having formed [n, n].
    dense = tlap.build_laplacian_matrix(torch.from_numpy(X), GraphParams(**p), normalized=normalized)
    assert float((got.dense() - dense.matrix).abs().max()) <= TOL


@pytest.mark.parametrize("reverse_k", ["auto", 1, 3])
def test_dropped_reverse_edges_counted_as_the_reference_counts(reverse_k, caplog):
    """A hub node (many rows point at it) overflows a pinned reverse
    capacity: both packages drop the same number of edges and keep the same
    ones; ``"auto"`` grows the capacity and drops none."""
    X = _nodes(240, 24, seed=5)
    X[40:120] = X[3] + 0.05 * X[40:120]          # 80 rows crowd around row 3
    eps, p, sigma = (np.float32(v) for v in (1.0, 2.0, 1.0))
    jnd, jidx = jlap._knn_dense_tiled(jnp.asarray(X), topk=4, normalise=False, row_tile=64)
    tnd, tidx = tlap._knn_dense_tiled(torch.from_numpy(X), 4, False, 64)
    assert np.array_equal(np.asarray(jidx), tidx.numpy())
    assert np.allclose(np.asarray(jnd), tnd.numpy(), atol=TOL)
    ref = jlap._ell_from_knn(jnd, jidx, jnp.float32(eps), jnp.float32(p), jnp.float32(sigma),
                             rk=reverse_k)
    with caplog.at_level(logging.INFO, logger=tlap.__name__):
        got = tlap._ell_from_knn(tnd, tidx, *(torch.tensor(v) for v in (eps, p, sigma)),
                                 rk=reverse_k)
    assert int(got[3]) == int(ref[3])
    assert (int(got[3]) == 0) == (reverse_k == "auto")
    _assert_same_rows(ref[0], ref[1], got[0], got[1])
    if reverse_k == "auto":
        assert got[0].shape[1] > 4 + 2 * 4           # grew past the default 2·kk
        assert any("grew to" in r.getMessage() for r in caplog.records)


def test_pinned_reverse_k_logs_the_dropped_count(caplog):
    X = _nodes(240, 24, seed=5)
    X[40:120] = X[3] + 0.05 * X[40:120]
    p = GraphParams(eps=1.0, k=6, topk=4, sparsity_check=False)
    with caplog.at_level(logging.WARNING, logger=tlap.__name__):
        gl = tlap.build_laplacian_ell(torch.from_numpy(X), p, reverse_k=2, row_tile=64)
    assert gl.ell().max_degree == 6
    assert any("reverse edges beyond the per-row capacity" in r.getMessage()
               for r in caplog.records)
    assert not gl.verify_properties()["symmetric"]   # the price of the pinned cap


def test_build_laplacian_matrix_routes_to_ell_from_direct_ell_n(monkeypatch):
    """From ``DIRECT_ELL_N`` nodes the builder returns an ELL-backed graph
    (the threshold lowered here so the route runs at a small size)."""
    monkeypatch.setattr(tlap, "DIRECT_ELL_N", 128)
    X = _nodes(200, 16, seed=6)
    p = GraphParams(eps=1.0, k=6, topk=4, sparsity_check=False)
    gl = tlap.build_laplacian_matrix(torch.from_numpy(X), p, n_items=5000)
    assert gl.is_ell_backed and gl.nnodes == 5000 and gl.shape == (200, 200)
    small = tlap.build_laplacian_matrix(torch.from_numpy(X[:100]), p)
    assert not small.is_ell_backed
    fk = tlap.build_laplacian_from_k_cluster(torch.from_numpy(X[:50].copy()), p, n_items=900)
    assert fk.shape == (16, 16) and not fk.is_ell_backed
    with pytest.raises(ValueError, match="too sparse"):
        tlap.build_laplacian_ell(torch.from_numpy(X),
                                 GraphParams(eps=1e-4, k=2, topk=2, sparsity_check=True))


@pytest.fixture(scope="module")
def graphs():
    X = _nodes(180, 20, seed=8)
    p = dict(eps=1.0, k=6, topk=5, sparsity_check=False)
    out = {}
    for normalized in (False, True):
        out[normalized] = (
            jlap.build_laplacian_ell(jnp.asarray(X), JGraphParams(**p), normalized=normalized),
            tlap.build_laplacian_ell(torch.from_numpy(X), GraphParams(**p), normalized=normalized),
            tlap.build_laplacian_matrix(torch.from_numpy(X), GraphParams(**p), normalized=normalized),
        )
    return out


@pytest.mark.parametrize("normalized", [False, True])
def test_ell_backed_graph_ops_match_reference_and_dense(graphs, normalized):
    ref, got, dense = graphs[normalized]
    assert got.shape == ref.shape == dense.shape
    assert got.nnz(1e-12) == ref.nnz(1e-12) == dense.nnz(1e-12)
    assert got.sparsity(1e-12) == pytest.approx(ref.sparsity(1e-12))
    assert np.allclose(np.asarray(ref.degrees()), got.degrees().numpy(), atol=TOL)
    assert np.allclose(got.degrees().numpy(), dense.degrees().numpy(), atol=TOL)
    for i in (0, 17, 179):
        assert np.array_equal(ref.neighbors_of(i), got.neighbors_of(i))
        assert np.array_equal(got.neighbors_of(i), dense.neighbors_of(i))
    rng = np.random.default_rng(9)
    x, V = (rng.normal(size=s).astype(np.float32) for s in ((180,), (180, 7)))
    # multiply_vector uses the stored diagonal: 1 for L_sym, not the degree.
    for v in (x, V):
        want = np.asarray(ref.multiply_vector(jnp.asarray(v)))
        assert np.allclose(got.multiply_vector(torch.from_numpy(v)).numpy(), want, atol=1e-5)
        assert np.allclose(dense.multiply_vector(torch.from_numpy(v)).numpy(), want, atol=1e-5)
    assert float(got.rayleigh_quotient(torch.from_numpy(x))) == pytest.approx(
        float(ref.rayleigh_quotient(jnp.asarray(x))), abs=1e-5)
    assert got.verify_properties() == ref.verify_properties()
    assert got.verify_properties()["row_sums_zero"] == (not normalized)
    rs, gs = ref.statistics(), got.statistics()
    assert rs.keys() == gs.keys()
    assert all(gs[k] == pytest.approx(rs[k], abs=1e-5) for k in rs)
    assert np.allclose(np.asarray(ref.adjacency()), got.adjacency().numpy(), atol=TOL)


def test_dense_graph_extracts_its_ell_once(graphs):
    _, _, dense = graphs[False]
    ell = dense.ell()
    assert dense.ell() is ell and not dense.is_ell_backed
    assert float((ell.to_dense() - dense.matrix).abs().max()) == 0.0
    gl = GraphLaplacian.from_ell(ell, dense.init_data, 180, dense.graph_params)
    assert gl.is_ell_backed and gl.ell() is ell
    assert torch.equal(gl.dense(), ell.to_dense())
