"""Port vs reference: the ring kNN, the sharded ELL Laplacian and
distributed LOBPCG (``parallel/knn_graph.py``), on 8 slots and 2 × 4.

Tolerances: kNN ids equal, distances within 1e-6 (one full-f32 product
each); ELL indices and dropped counts equal, weights within 1e-6 and the
diagonal within 1e-5 (sums of up to 2k weights); LOBPCG from the same
start block (``np.random.default_rng(seed)``, bit for bit) converges to
eigenvalues within 1e-4 relative to the spectrum's scale on a graph where
both solves converge.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu.graph import GraphParams as JGraphParams
from matternet_rs_tpu.parallel import knn_graph as jkg
from matternet_rs_tpu.parallel import mesh as jmesh

from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.ops.kernels import spmv_ell as fk
from matternet_rs_tpu_torch.parallel import knn_graph as tkg
from matternet_rs_tpu_torch.parallel import mesh as tmesh

CPU = torch.device("cpu")


def _meshes(kind):
    if kind == "1d":
        return jmesh.make_mesh(8), tmesh.make_mesh(8, devices=[CPU] * 8)
    return jmesh.make_mesh_2d(2, 4), tmesh.make_mesh_2d(2, 4, devices=[CPU] * 8)


def _clustered(n, f, centres, spread, seed):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centres, f)) * 3.0
    return (c[rng.integers(0, centres, n)] + rng.normal(size=(n, f)) * spread).astype(np.float32)


def _pair(kind, X):
    jm, tm = _meshes(kind)
    return jm, tm, jmesh.shard_items(jm, jnp.asarray(X)), tmesh.shard_items(tm, X)


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("normalise", [False, True])
@pytest.mark.parametrize("n,k", [(190, 6), (37, 8), (9, 12)])
def test_ring_knn(kind, normalise, n, k):
    X = _clustered(n, 16, 3, 0.8, seed=n)
    jm, tm, jX, tX = _pair(kind, X)
    jd, ji = jkg.distributed_knn(jm, jX, n, k, normalise=normalise)
    td, ti = tkg.distributed_knn(tm, tX, n, k, normalise=normalise)
    jd, ji = np.asarray(jd), np.asarray(ji)
    td, ti = td.gather().numpy(), ti.gather().numpy()
    assert np.array_equal(ti, ji)
    fin = np.isfinite(jd)
    assert np.array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], atol=1e-6)
    assert np.all(ti[n:] == -1)


def _ell_equal(je, te):
    assert np.array_equal(te.indices.gather().numpy(), np.asarray(je.indices))
    np.testing.assert_allclose(te.weights.gather().numpy(), np.asarray(je.weights), atol=1e-6)
    np.testing.assert_allclose(te.diag.gather().numpy(), np.asarray(je.diag), atol=1e-5)
    assert te.dropped_reverse_edges == je.dropped_reverse_edges
    assert te.n_items == je.n_items


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("normalise", [False, True])
@pytest.mark.parametrize("reverse_k", [None, 2, "auto"])
def test_ell_laplacian(kind, normalise, reverse_k):
    n = 190
    X = _clustered(n, 16, 3, 0.8, seed=5)
    jm, tm, jX, tX = _pair(kind, X)
    kw = dict(eps=1.0, k=6, topk=6, sparsity_check=False, normalise=normalise)
    je = jkg.distributed_knn_ell_laplacian(jm, jX, n, JGraphParams(**kw), reverse_k=reverse_k)
    te = tkg.distributed_knn_ell_laplacian(tm, tX, n, GraphParams(**kw), reverse_k=reverse_k)
    _ell_equal(je, te)
    if reverse_k == "auto":
        assert te.dropped_reverse_edges == 0
        np.testing.assert_allclose(te.to_dense(), te.to_dense().T, atol=0)
    assert te.edge_list_bytes > 0
    np.testing.assert_allclose(te.to_dense(), je.to_dense(), atol=1e-5)


def test_sparsified_ell_on_a_dense_neighbourhood():
    """A mean degree above 10 takes the degree sparsification."""
    n = 240
    X = _clustered(n, 8, 2, 0.3, seed=9)
    jm, tm, jX, tX = _pair("1d", X)
    kw = dict(eps=2.0, k=14, topk=14, sparsity_check=False)
    je = jkg.distributed_knn_ell_laplacian(jm, jX, n, JGraphParams(**kw))
    te = tkg.distributed_knn_ell_laplacian(tm, tX, n, GraphParams(**kw))
    _ell_equal(je, te)


def test_max_indegree():
    n = 190
    X = _clustered(n, 16, 3, 0.8, seed=5)
    jm, tm, jX, tX = _pair("1d", X)
    _, ji = jkg.distributed_knn(jm, jX, n, 6)
    _, ti = tkg.distributed_knn(tm, tX, n, 6)
    assert tkg._max_indegree_device(tm, ti, n) == jkg._max_indegree_device(jm, "data", ji, n)


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_lobpcg_converges_to_the_reference_eigenvalues(kind):
    n, k = 192, 5
    X = _clustered(n, 16, 1, 1.0, seed=3)
    jm, tm, jX, tX = _pair(kind, X)
    kw = dict(eps=1.0, k=8, topk=8, sparsity_check=False)
    je = jkg.distributed_knn_ell_laplacian(jm, jX, n, JGraphParams(**kw), reverse_k="auto")
    te = tkg.distributed_knn_ell_laplacian(tm, tX, n, GraphParams(**kw), reverse_k="auto")
    rv, rvec, rres = jkg.distributed_lobpcg(jm, je, k, iters=300, seed=4, return_residuals=True)
    gv, gvec, gres = tkg.distributed_lobpcg(tm, te, k, iters=300, seed=4, return_residuals=True)
    scale = max(abs(float(rv[-1])), 1e-3)
    exact = np.linalg.eigvalsh(te.to_dense())[:k]
    assert np.max(np.abs(rv - exact)) <= 1e-4 * scale    # both solves converged
    np.testing.assert_allclose(gv, rv, rtol=0, atol=1e-4 * scale)
    assert gvec.shape == (n, k) and np.max(gres) < 1e-2 * scale + 1e-3
    # The residuals are ‖L·x − θ·x‖ under the dense form.
    L = te.to_dense()
    for j in range(k):
        r = np.linalg.norm(L @ gvec[:, j] - gv[j] * gvec[:, j])
        assert gres[j] == pytest.approx(r, rel=0.05, abs=1e-3)


def test_lobpcg_start_block_is_the_reference_draw(monkeypatch):
    n = 40
    X = _clustered(n, 8, 1, 1.0, seed=1)
    _, tm, _, tX = _pair("1d", X)
    te = tkg.distributed_knn_ell_laplacian(tm, tX, n, GraphParams(eps=1.0, k=4, topk=4,
                                                                  sparsity_check=False))
    seen = {}
    real = tkg._lobpcg_core

    def spy(matvec, X0, k, iters):
        seen["X0"] = X0
        return real(matvec, X0, k, iters)

    monkeypatch.setattr(tkg, "_lobpcg_core", spy)
    tkg.distributed_lobpcg(tm, te, 3, iters=2, seed=11)
    ref = np.asarray(jnp.asarray(np.random.default_rng(11).normal(size=(40, 3)), jnp.float32))
    assert np.array_equal(seen["X0"].numpy(), ref)


@pytest.mark.parametrize("row0,n,m", [(0, 7, 3), (5, 4, 1), (13, 3, 17)])
def test_spmv_ell_rows_is_the_square_product_s_rows(row0, n, m):
    """Kernel F's rows form (its plain version here) gives rows
    ``row0 .. row0 + n − 1`` of the square product, bit for bit."""
    nx = 16
    rng = np.random.default_rng(row0 + m)
    idx = torch.from_numpy(rng.integers(-1, nx, (nx, 5)).astype(np.int32))
    w = torch.from_numpy(rng.random((nx, 5)).astype(np.float32)) * (idx >= 0)
    d = torch.from_numpy(rng.random(nx).astype(np.float32))
    V = torch.from_numpy(rng.normal(size=(nx, m)).astype(np.float32))
    full = fk.spmv_ell(idx, w, V, d)
    rows = fk.spmv_ell(idx[row0:row0 + n], w[row0:row0 + n], V, d[row0:row0 + n], row0)
    assert torch.equal(rows, full[row0:row0 + n])
    assert torch.equal(fk.spmv_ell(idx[row0:row0 + n], w[row0:row0 + n], V),
                       fk.spmv_ell(idx, w, V)[row0:row0 + n])
    with pytest.raises(ValueError, match="outside"):
        fk.spmv_ell(idx, w, V[:4])
    with pytest.raises(ValueError, match="row0"):
        fk.spmv_ell(idx[:3], w[:3], V, d[:3], nx - 1)
