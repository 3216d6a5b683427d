"""Port vs reference: the sparse λ route (``taumode_lambdas_ell`` and its
routing), ``graph_for_taumode``'s ELL serving, and the large-F slice as a
whole — an ELL-backed graph built by the JAX package, carried across as
arrays, then ``compute_taumode`` and ``search_batch`` in both packages.

Tolerances: λ 1e-6 (the cases of ``tests/test_large_f.py``; the edge-wise
sums run in another order than XLA's); normalised λ and its stats
1e-5·max(1, |x|); ids under the near-tie rule, scores 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu import core as jcore
from matternet_rs_tpu.graph import GraphParams as JGraphParams
from matternet_rs_tpu.ops import csr as jcsr
from matternet_rs_tpu.ops import laplacian as jlap
from matternet_rs_tpu.ops import taumode as jtm

from matternet_rs_tpu_torch import convert
from matternet_rs_tpu_torch import core as tcore
from matternet_rs_tpu_torch.graph import GraphLaplacian, GraphParams
from matternet_rs_tpu_torch.ops import csr as tcsr
from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops import taumode as ttm
from matternet_rs_tpu_torch.utils.parity import topk_mismatches

K = 10


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


def _both_ells(L):
    return jcsr.ell_from_dense_laplacian(jnp.asarray(L)), tcsr.ell_from_dense_laplacian(
        torch.from_numpy(L))


def _close(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return np.all(np.abs(ref - got) <= 1e-5 * np.maximum(1.0, np.abs(ref)))


@pytest.mark.parametrize("mode,param", [(ttm.TAU_MEDIAN, 0.0), (ttm.TAU_MEAN, 0.0),
                                        (ttm.TAU_FIXED, 0.4), (ttm.TAU_PERCENTILE, 0.3)])
def test_sparse_lambda_matches_reference(mode, param):
    L = _topk_laplacian(300, 8, seed=3)
    jell, tell = _both_ells(L)
    X = np.random.default_rng(4).normal(size=(600, 300)).astype(np.float32)
    X[5] = 0.0                                   # a zero row scores 0
    ref = np.asarray(jtm.taumode_lambdas_ell(jnp.asarray(X), jell, mode, param))
    got = ttm.taumode_lambdas_ell(torch.from_numpy(X), tell, mode, param).numpy()
    assert np.allclose(ref, got, atol=1e-6)
    assert got[5] == 0.0
    # ... and both equal the dense closed form.
    dense = ttm.taumode_lambdas(torch.from_numpy(X), torch.from_numpy(L), mode, param).numpy()
    assert np.allclose(dense, got, atol=1e-6)


def test_sparse_lambda_across_chunk_boundaries():
    L = _topk_laplacian(64, 4, seed=5)
    jell, tell = _both_ells(L)
    X = np.random.default_rng(6).normal(size=(1100, 64)).astype(np.float32)
    ref = np.asarray(jtm.taumode_lambdas_ell(jnp.asarray(X), jell, jtm.TAU_MEDIAN, item_chunk=256))
    Xt = torch.from_numpy(X)
    got = ttm.taumode_lambdas_ell(Xt, tell, ttm.TAU_MEDIAN, item_chunk=256)
    assert got.shape == (1100,)
    assert np.allclose(ref, got.numpy(), atol=1e-6)
    for chunk in (1, 7, 1100, 4096):             # λ is row-independent
        assert np.allclose(ttm.taumode_lambdas_ell(Xt, tell, item_chunk=chunk).numpy(),
                           got.numpy(), atol=1e-7)
    one = ttm.synthetic_lambda(Xt[3], tell)
    assert one.ndim == 0 and float(one) == pytest.approx(float(got[3]), abs=1e-7)
    assert float(jtm.synthetic_lambda(jnp.asarray(X[3]), jell)) == pytest.approx(float(one), abs=1e-6)


def test_sparse_lambda_with_minus_one_slots_of_the_direct_build():
    """The direct build marks empty slots with −1; λ ignores them."""
    nodes = np.random.default_rng(7).normal(size=(120, 12)).astype(np.float32)
    p = dict(eps=1.0, k=6, topk=4, sparsity_check=False)
    jgl = jlap.build_laplacian_ell(jnp.asarray(nodes), JGraphParams(**p))
    tell = convert.ell_from_arrays(np.asarray(jgl.ell().indices), np.asarray(jgl.ell().weights),
                                   np.asarray(jgl.ell().diag), device="cpu")
    assert int((tell.indices < 0).sum()) > 0
    X = np.random.default_rng(8).normal(size=(90, 120)).astype(np.float32)
    ref = np.asarray(jtm.taumode_lambdas_ell(jnp.asarray(X), jgl.ell()))
    assert np.allclose(ref, ttm.taumode_lambdas_ell(torch.from_numpy(X), tell).numpy(), atol=1e-6)


def test_auto_routes_sparse_beyond_threshold_and_for_an_ell_at_any_f():
    f = ttm.SPARSE_F_THRESHOLD + 32
    L = _topk_laplacian(f, 5, seed=7)
    X = np.random.default_rng(8).normal(size=(64, f)).astype(np.float32)
    ref = np.asarray(jtm.taumode_lambdas_auto(jnp.asarray(X), jnp.asarray(L), jtm.TAU_MEDIAN))
    Xt, Lt = torch.from_numpy(X), torch.from_numpy(L)
    kernels.reset_launches()
    auto = ttm.taumode_lambdas_auto(Xt, Lt, ttm.TAU_MEDIAN).numpy()
    assert np.allclose(ref, auto, atol=1e-6)
    tell = tcsr.ell_from_dense_laplacian(Lt)
    assert np.array_equal(ttm.taumode_lambdas_auto(Xt, tell, ttm.TAU_MEDIAN).numpy(), auto)
    assert np.allclose(ttm.taumode_lambdas(Xt, Lt).numpy(), auto, atol=1e-6)
    # An EllLaplacian takes the sparse route at any F.
    Ls = _topk_laplacian(48, 4, seed=9)
    Xs = torch.from_numpy(np.random.default_rng(10).normal(size=(20, 48)).astype(np.float32))
    small = ttm.taumode_lambdas_auto(Xs, tcsr.ell_from_dense_laplacian(torch.from_numpy(Ls)))
    assert np.allclose(small.numpy(), ttm.taumode_lambdas(Xs, torch.from_numpy(Ls)).numpy(), atol=1e-6)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


def test_graph_for_taumode_serves_a_cached_ell_beyond_threshold():
    f = ttm.SPARSE_F_THRESHOLD + 8
    L = _topk_laplacian(f, 5, seed=9)
    gl = GraphLaplacian(matrix=torch.from_numpy(L), init_data=torch.zeros(f, 2), nnodes=10,
                        graph_params=GraphParams(sparsity_check=False))
    X = np.random.default_rng(10).normal(size=(40, f)).astype(np.float32)
    aspace = tcore.ArrowSpace.from_items(X, device="cpu")
    graph = aspace.graph_for_taumode(gl)
    assert isinstance(graph, tcsr.EllLaplacian)
    assert gl.ell() is graph and aspace.graph_for_taumode(gl) is graph     # cached
    aspace.compute_taumode(gl)
    jgl_ref = np.asarray(jtm.taumode_lambdas(jnp.asarray(X), jnp.asarray(L), jtm.TAU_MEDIAN))
    mn = jgl_ref.min()
    rng = max(max(jgl_ref.max(), 0.0) - mn, 1e-9)
    assert np.allclose(aspace.lambdas.numpy(), np.clip((jgl_ref - mn) / rng, 0, 1), atol=1e-5)
    ql = aspace.prepare_query_item(X[3], gl)                               # the query path
    assert aspace.search_lambda_aware(X[3], ql, 5)[0][0] == 3
    with pytest.raises(ValueError, match="doesn't match"):
        aspace.prepare_query_item(X[3, :100], gl)


def test_signals_ell_is_cached_and_follows_a_replaced_signals():
    f = ttm.SPARSE_F_THRESHOLD + 16
    gl = GraphLaplacian(matrix=torch.from_numpy(_topk_laplacian(f, 4, seed=21)),
                        init_data=torch.zeros(f, 2), nnodes=10,
                        graph_params=GraphParams(sparsity_check=False))
    aspace = tcore.ArrowSpace.from_items(
        np.random.default_rng(22).normal(size=(20, f)).astype(np.float32), device="cpu")
    aspace.signals = torch.from_numpy(_topk_laplacian(f, 4, seed=23))
    g1 = aspace.graph_for_taumode(gl)
    assert isinstance(g1, tcsr.EllLaplacian) and aspace.graph_for_taumode(gl) is g1
    assert np.allclose(g1.to_dense().numpy(), aspace.signals.numpy(), atol=1e-6)
    aspace.signals = torch.from_numpy(_topk_laplacian(f, 4, seed=24))
    g2 = aspace.graph_for_taumode(gl)
    assert g2 is not g1 and np.allclose(g2.to_dense().numpy(), aspace.signals.numpy(), atol=1e-6)
    small = tcore.ArrowSpace.from_items(np.ones((4, 16), np.float32), device="cpu")
    small.signals = torch.eye(16)
    assert small.graph_for_taumode(gl) is small.signals                    # dense below it


@pytest.fixture(scope="module")
def ell_slice():
    """N = 500 items of F = 300 features; the feature graph is built by the
    reference's direct ELL build over 40 centroids and carried across."""
    rng = np.random.default_rng(31)
    X = rng.normal(size=(500, 300)).astype(np.float32)
    cents = np.stack([X[rng.choice(500, 20, replace=False)].mean(0) for _ in range(40)])
    p = dict(eps=1.0, k=6, topk=4, sparsity_check=False)
    jgl = jlap.build_laplacian_ell(jnp.asarray(cents.T), JGraphParams(**p), n_items=500)
    ja = jcore.ArrowSpace.from_items(X)
    ja.compute_taumode(jgl)
    e = jgl.ell()
    ell_arrays = (np.asarray(e.indices), np.asarray(e.weights), np.asarray(e.diag))
    Q = X[rng.choice(500, 16, replace=False)]
    return X, Q, ja, jgl, ell_arrays, p


def test_large_f_slice_matches_reference(ell_slice):
    X, Q, ja, jgl, ell_arrays, p = ell_slice
    tgl = convert.graph_from_arrays(ell_arrays, graph_params=p, nnodes=500, device="cpu")
    assert tgl.is_ell_backed and tgl.shape == (300, 300) and tgl.nnodes == 500
    assert tgl.ell().indices.dtype == torch.int32
    ta = tcore.ArrowSpace.from_items(X, device="cpu")
    kernels.reset_launches()
    ta.compute_taumode(tgl)
    for s in ("min_lambdas", "max_lambdas", "range_lambdas"):
        assert _close(getattr(ja, s), getattr(ta, s)), s
    assert _close(np.asarray(ja.lambdas), ta.lambdas.numpy())
    ref_idx, ref_sc, ref_raw = ja.search_batch(Q, jgl, K + 1, alpha=0.7, return_raw=True)
    idx, sc, raw = ta.search_batch(Q, tgl, K, alpha=0.7, return_raw=True)
    assert _close(ref_raw, raw)
    assert not topk_mismatches(ref_idx, ref_sc, idx, sc)
    ql = ta.prepare_query_item(Q[0], tgl)
    assert ql == pytest.approx(ja.prepare_query_item(Q[0], jgl), abs=1e-5)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


def test_converted_ell_index_searches_like_reference(ell_slice):
    """The whole JAX-built index — data, normalised λ and the ELL graph —
    carried across with ``arrowspace_from_arrays``."""
    X, Q, ja, jgl, ell_arrays, p = ell_slice
    ta, tgl = convert.arrowspace_from_arrays(
        np.asarray(ja.data), np.asarray(ja.lambdas), ell_arrays,
        min_lambdas=ja.min_lambdas, max_lambdas=ja.max_lambdas, range_lambdas=ja.range_lambdas,
        graph_params=p, tau_mode=(ja.taumode.mode, ja.taumode.param), device="cpu",
    )
    assert tgl.is_ell_backed
    ref_idx, ref_sc = ja.search_batch(Q, jgl, K + 1)
    idx, sc = ta.search_batch(Q, tgl, K)
    assert not topk_mismatches(ref_idx, ref_sc, idx, sc)
    assert np.allclose(tgl.dense().numpy(), np.asarray(jgl.dense()), atol=1e-6)


def test_convert_rejects_a_bad_ell_and_keeps_the_dense_form():
    idx = np.array([[1, 5], [0, 0]], np.int64)
    w = np.array([[0.5, 0.25], [0.5, 0.0]], np.float32)
    with pytest.raises(ValueError, match="outside"):
        convert.ell_from_arrays(idx, w, w.sum(1), device="cpu")
    gl = convert.graph_from_arrays(np.eye(3, dtype=np.float32), device="cpu")
    assert not gl.is_ell_backed and gl.nnodes == 3
