"""Port vs reference: the ELL containers and sparse products
(``ops/csr.py``). The same numpy arrays go through both packages; the
port's products take kernel F's plain version on the CPU. Where the
reference has a Pallas kernel for the product it runs in interpret mode.

Tolerances: the containers' arrays are equal; products 1e-5 (f32 sums of a
few terms of magnitude ≤ a few units, in another order than XLA's)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu.ops import csr as jcsr
from matternet_rs_tpu.ops.pallas import spmv_ell as jpk

from matternet_rs_tpu_torch.ops import csr as tcsr
from matternet_rs_tpu_torch.ops.kernels import spmv_ell as tfk

TOL = 1e-5


def _graph(n=300, density=0.05, seed=0):
    """The adjacency of ``tests/test_spmv_pallas.py``."""
    rng = np.random.default_rng(seed)
    W = rng.random((n, n)) * (rng.random((n, n)) > 1 - density)
    W = np.maximum(W, W.T)
    np.fill_diagonal(W, 0.0)
    return W


def _topk_laplacian(f, k, seed=0):
    """The Laplacian of ``tests/test_large_f.py``."""
    rng = np.random.default_rng(seed)
    W = np.zeros((f, f), np.float32)
    for i in range(f):
        nbrs = rng.choice(f - 1, k, replace=False)
        nbrs[nbrs >= i] += 1
        W[i, nbrs] = rng.random(k).astype(np.float32)
    W = np.maximum(W, W.T)
    return np.diag(W.sum(1)).astype(np.float32) - W


def _t(a):
    return torch.from_numpy(np.array(a))


def test_sparse_graph_from_edges_equals_reference():
    rng = np.random.default_rng(1)
    edges = [(int(u), int(v), float(w)) for u, v, w in
             zip(rng.integers(0, 40, 200), rng.integers(0, 40, 200), rng.random(200))]
    edges += [(3, 3, 1.0), (5, 7, 0.25), (7, 5, 0.75)]          # self loop, duplicate
    for max_degree in (None, 4):
        ref = jcsr.SparseGraph.from_edges(edges, 40, max_degree)
        got = tcsr.SparseGraph.from_edges(edges, 40, max_degree, device="cpu")
        assert got.indices.dtype == torch.int32
        assert np.array_equal(np.asarray(ref.indices), got.indices.numpy())
        assert np.array_equal(np.asarray(ref.weights), got.weights.numpy())
        assert np.allclose(np.asarray(ref.degrees()), got.degrees().numpy(), atol=1e-6)
        assert np.allclose(np.asarray(ref.to_laplacian_dense()),
                           got.to_laplacian_dense().numpy(), atol=1e-6)


@pytest.mark.parametrize("max_degree", [None, 6])
def test_sparse_graph_from_dense_equals_reference(max_degree):
    W = _graph(120, seed=2)
    ref = jcsr.SparseGraph.from_dense(W, max_degree)
    got = tcsr.SparseGraph.from_dense(W, max_degree, device="cpu")
    assert np.array_equal(np.asarray(ref.indices), got.indices.numpy())
    assert np.array_equal(np.asarray(ref.weights), got.weights.numpy())
    assert np.array_equal(np.asarray(ref.to_dense_adjacency()), got.to_dense_adjacency().numpy())


@pytest.mark.parametrize("f,k,max_degree", [(150, 6, None), (128, 5, None), (90, 7, 4)])
def test_ell_from_dense_laplacian_equals_reference(f, k, max_degree):
    L = _topk_laplacian(f, k, seed=f)
    ref = jcsr.ell_from_dense_laplacian(jnp.asarray(L), max_degree)
    got = tcsr.ell_from_dense_laplacian(_t(L), max_degree)
    assert got.shape == ref.shape == (f, f) and got.max_degree == ref.max_degree
    assert np.array_equal(np.asarray(ref.indices), got.indices.numpy())
    assert np.array_equal(np.asarray(ref.weights), got.weights.numpy())
    assert np.array_equal(np.asarray(ref.diag), got.diag.numpy())
    assert np.array_equal(np.asarray(ref.to_dense()), got.to_dense().numpy())
    if max_degree is None:                       # lossless round trip
        assert float((got.to_dense() - _t(L)).abs().max()) == 0.0


@pytest.mark.parametrize("n,m,seed", [(300, 8, 0), (300, 4, 2), (137, 3, 4)])
def test_products_match_reference_and_pallas_interpret(n, m, seed):
    """The graphs of ``tests/test_spmv_pallas.py``: ``spmv_ell`` on a block
    and on one vector, ``laplacian_spmv_ell`` and ``spmv_ell_scan`` against
    the reference's XLA forms and its Pallas kernel in interpret mode."""
    W = _graph(n, seed=seed)
    g = jcsr.SparseGraph.from_dense(W)
    X = np.random.default_rng(seed + 1).normal(size=(n, m)).astype(np.float32)
    idx, w = _t(g.indices), _t(g.weights)
    Xj, Xt = jnp.asarray(X), _t(X)

    got = tcsr.spmv_ell(idx, w, Xt).numpy()
    assert np.allclose(got, np.asarray(jcsr.spmv_ell(g.indices, g.weights, Xj)), atol=TOL)
    assert np.allclose(got, np.asarray(jpk.spmv_ell_pallas(g.indices, g.weights, Xj, interpret=True)),
                       atol=TOL)
    assert np.allclose(got, W.astype(np.float32) @ X, atol=1e-4)
    assert np.array_equal(tcsr.spmv_ell_scan(idx, w, Xt).numpy(), got)
    assert np.allclose(got, np.asarray(jcsr.spmv_ell_scan(g.indices, g.weights, Xj)), atol=TOL)

    vec = tcsr.spmv_ell(idx, w, Xt[:, 0]).numpy()
    assert vec.shape == (n,)
    assert np.allclose(vec, np.asarray(jcsr.spmv_ell(g.indices, g.weights, Xj[:, 0])), atol=TOL)

    lap = tcsr.laplacian_spmv_ell(idx, w, Xt).numpy()
    assert np.allclose(lap, np.asarray(jcsr.laplacian_spmv_ell(g.indices, g.weights, Xj)), atol=TOL)
    assert np.allclose(
        lap, np.asarray(jpk.laplacian_spmv_ell_pallas(g.indices, g.weights, Xj, interpret=True)),
        atol=TOL)
    lap1 = tcsr.laplacian_spmv_ell(idx, w, Xt[:, 0]).numpy()
    assert np.allclose(lap1, lap[:, 0], atol=TOL)


def _ell_with_empty_slots(n=60, k=5, seed=7):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n - 1, size=(n, k)).astype(np.int32)   # no slot names row n-1
    w = rng.random((n, k)).astype(np.float32)
    w[rng.random((n, k)) < 0.4] = 0.0
    return idx, w


@pytest.mark.parametrize("fill", [-1, 59, 10**6])
def test_empty_slots_contribute_nothing_whatever_their_index(fill):
    """Weight 0 marks an empty slot: its index (−1 from the direct build,
    a row of non-finite values, or a value far out of range) is never
    used."""
    idx, w = _ell_with_empty_slots()
    X = np.random.default_rng(8).normal(size=(60, 4)).astype(np.float32)
    ref = tcsr.spmv_ell(_t(idx), _t(w), _t(X))
    X_inf = X.copy()
    X_inf[59] = np.inf
    filled = np.where(w != 0, idx, fill).astype(np.int32)
    got = tcsr.spmv_ell(_t(filled), _t(w), _t(X_inf))
    assert torch.equal(got, ref)
    d = _t(w.sum(1))
    assert torch.equal(tfk.spmv_ell(_t(filled), _t(w), _t(X), d), d[:, None] * _t(X) - ref)


@pytest.mark.parametrize("value", [60, -1, -61])
def test_live_slot_out_of_range_raises(value):
    idx, w = _ell_with_empty_slots()
    r, c = np.argwhere(w != 0)[0]
    idx[r, c] = value
    X = torch.zeros(60, 2)
    with pytest.raises(ValueError, match="outside"):
        tcsr.spmv_ell(_t(idx), _t(w), X)
    ell = tcsr.EllLaplacian(_t(idx), _t(w), _t(w.sum(1)))
    with pytest.raises(ValueError, match="outside"):
        ell.matvec(X)


def test_indices_must_be_int32_and_check_runs_once():
    idx, w = _ell_with_empty_slots()
    with pytest.raises(ValueError, match="int32"):
        tcsr.spmv_ell(_t(idx.astype(np.int64)), _t(w), torch.zeros(60, 2))
    ell = tcsr.EllLaplacian(_t(idx), _t(w), _t(w.sum(1)))
    assert ell.check() is ell and ell._checked
    ell.indices[0, 0] = 99                # a later corruption is not re-read
    ell.check()
    assert ell.nbytes() == 60 * 5 * 8 + 60 * 4


def test_ell_matvec_honours_the_stored_diagonal():
    L = _topk_laplacian(80, 4, seed=9)
    ell = tcsr.ell_from_dense_laplacian(_t(L))
    V = _t(np.random.default_rng(10).normal(size=(80, 6)).astype(np.float32))
    assert np.allclose(ell.matvec(V).numpy(), L @ V.numpy(), atol=TOL)
    ell.diag = torch.ones(80)
    assert np.allclose(ell.matvec(V[:, 0]).numpy(),
                       ((np.eye(80, dtype=np.float32) - np.diag(np.diag(L)) + L) @ V[:, 0].numpy()),
                       atol=TOL)
