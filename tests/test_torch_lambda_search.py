"""Port vs reference: the λ-band, hybrid, sorted-index and range searches
(``ops/search.py``'s ``cosine_scores``, ``lambda_aware_scores``,
``search_lambda_aware_hybrid``, ``search_lambda_banded``,
``range_search_mask``; ``index/sorted.py``'s device index; the
``ArrowSpace`` methods over them), on JAX-CPU and torch-CPU with the same
numpy inputs, plus the cases of ``tests/test_core_search.py`` and
``tests/test_api_surface.py`` that reach them.

Both packages search the same index: the reference's λ carried into the
port with ``convert`` (``carried``), so every search sees equal λ. Ids
equal; scores, cosines and λ distances within 1e-5 (dots summed in
another order). The sorted-index searches through ``ArrowSpace`` take
each package's own query λ (within 1e-6 of each other), so there ids may
trade places only where their |Δλ| agree within 1e-6; at one query λ the
two indexes answer alike. The port's own build (``built``, the reference's
``make_gaussian_blob(80, 0.5)`` fixture) runs the reference's cases.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu.builder import ArrowSpaceBuilder as JBuilder
from matternet_rs_tpu.index.sorted import DeviceSortedLambdas as JDeviceSorted
from matternet_rs_tpu.index.sorted import SortedLambdas as JSorted
from matternet_rs_tpu.ops import search as jsearch
from matternet_rs_tpu.utils.fixtures import make_gaussian_blob

from matternet_rs_tpu_torch import convert
from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder as TBuilder
from matternet_rs_tpu_torch.core import ArrowSpace
from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.index.sorted import DeviceSortedLambdas, SortedLambdas
from matternet_rs_tpu_torch.ops import laplacian as lap
from matternet_rs_tpu_torch.ops import search as tsearch
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset
from matternet_rs_tpu_torch.utils.parity import same_k_mismatches

CPU = "cpu"
TOL = 1e-5


@pytest.fixture(scope="module")
def built():
    data = make_gaussian_blob(80, 0.5).astype(np.float32)
    aspace = ArrowSpace.from_items(data, device=CPU)
    gl = lap.build_laplacian_from_k_cluster(
        torch.from_numpy(data[:10].copy()), GraphParams(eps=1.0, k=5, topk=5, sparsity_check=False),
        n_items=len(data))
    aspace.compute_taumode(gl)
    aspace.build_lambdas_sorted()
    return aspace, gl, data


@pytest.fixture(scope="module", params=[False, True], ids=["host-sorted", "device-sorted"])
def carried(request):
    """The reference's build of 1,500 × 24 rows and the same index in the
    port, its sorted index on the host or on the (CPU) device."""
    X = make_energy_test_dataset(1500, 24, seed=5).astype(np.float32)
    ja, jg = (JBuilder().with_lambda_graph(1.0, 6).with_sparsity_check(False)
              .with_cluster_params(max_clusters=30, radius=6.0).with_sampling(None).build(X))
    ta, tg = convert.arrowspace_from_arrays(
        np.asarray(ja.data), np.asarray(ja.lambdas), np.asarray(jg.matrix),
        min_lambdas=ja.min_lambdas, max_lambdas=ja.max_lambdas, range_lambdas=ja.range_lambdas,
        graph_params=dataclasses.asdict(jg.graph_params), init_data=np.asarray(jg.init_data),
        nnodes=jg.nnodes, device=CPU)
    ta.build_lambdas_sorted(on_device=request.param)
    ja.build_lambdas_sorted(on_device=request.param)
    rng = np.random.default_rng(8)
    Q = (X[rng.integers(0, len(X), 12)] + rng.normal(0, 0.05, (12, X.shape[1]))).astype(np.float32)
    return X, Q, ja, jg, ta, tg


def _same(ref, got, tol=TOL):
    assert [i for i, _ in got] == [i for i, _ in ref]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], atol=tol, rtol=0)


# --------------------------------------------------- against the reference


def test_cosine_and_lambda_aware_scores(carried):
    X, Q, ja, _, ta, _ = carried
    for q in Q[:4]:
        ref_c = np.asarray(jsearch.cosine_scores(ja.data, ja.norms, jnp.asarray(q)))
        got_c = tsearch.cosine_scores(ta.data, ta.norms, torch.from_numpy(q)).numpy()
        np.testing.assert_allclose(got_c, ref_c, atol=TOL, rtol=0)
        ref = np.asarray(jsearch.lambda_aware_scores(ja.data, ja.norms, ja.lambdas, jnp.asarray(q),
                                                     jnp.float32(0.4), jnp.float32(0.7)))
        got = tsearch.lambda_aware_scores(ta.data, ta.norms, ta.lambdas, torch.from_numpy(q),
                                          0.4, 0.7).numpy()
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_cosine_scores_on_a_bf16_copy():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(50, 16)).astype(np.float32)
    q = rng.normal(size=16).astype(np.float32)
    norms = np.linalg.norm(X, axis=1).astype(np.float32)
    ref = np.asarray(jsearch.cosine_scores(jnp.asarray(X, jnp.bfloat16), jnp.asarray(norms),
                                           jnp.asarray(q)))
    got = tsearch.cosine_scores(torch.from_numpy(X).to(torch.bfloat16), torch.from_numpy(norms),
                                torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("k", [1, 5, 10, 40])
def test_hybrid_matches_reference(carried, k):
    X, Q, ja, jg, ta, tg = carried
    for q in list(Q[:6]) + [X[3], X[700]]:
        ql = ja.prepare_query_item(q, jg)
        _same(ja.search_lambda_aware_hybrid(q, ql, k), ta.search_lambda_aware_hybrid(q, ql, k))
    assert ta.search_lambda_aware_hybrid(Q[0], 0.5, 0) == []


def test_hybrid_keeps_every_high_cosine_row_and_the_argmax():
    """Duplicated rows (cosine 1 > 0.9999) join the candidates whatever
    their λ and score their cosine; the first argmax of the cosine is
    kept; ties go to the lowest index in both packages."""
    rng = np.random.default_rng(6)
    X = rng.normal(size=(60, 8)).astype(np.float32)
    X[[10, 20, 30]] = X[5]
    lam = rng.random(60).astype(np.float32)
    norms = np.linalg.norm(X, axis=1).astype(np.float32)
    q = X[5] * 2.0
    for k in (1, 2, 6):
        ri, rs = jsearch.search_lambda_aware_hybrid(jnp.asarray(X), jnp.asarray(norms),
                                                    jnp.asarray(lam), jnp.asarray(q),
                                                    jnp.float32(0.9), k, 0.7)
        gi, gs = tsearch.search_lambda_aware_hybrid(torch.from_numpy(X), torch.from_numpy(norms),
                                                    torch.from_numpy(lam), torch.from_numpy(q),
                                                    0.9, k, 0.7)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(gs.numpy(), np.asarray(rs), atol=TOL, rtol=0)
    assert set(gi.numpy()[:4]) == {5, 10, 20, 30}


@pytest.mark.parametrize("window", [1, 16, 256, 4096])
def test_banded_matches_reference(carried, window):
    X, Q, ja, jg, ta, tg = carried
    for q in list(Q[:6]) + [X[0], X[-1]]:
        ql = ja.prepare_query_item(q, jg)
        _same(ja.search_lambda_banded(q, ql, 10, window=window),
              ta.search_lambda_banded(q, ql, 10, window=window))


@pytest.mark.parametrize("q_lam", [-0.5, 0.0, 0.3, 1.0, 2.0])
def test_banded_window_is_clipped_at_both_ends(carried, q_lam):
    X, Q, ja, jg, ta, tg = carried
    _same(ja.search_lambda_banded(Q[1], q_lam, 7, window=64),
          ta.search_lambda_banded(Q[1], q_lam, 7, window=64))


@pytest.mark.parametrize("eps", [-0.2, 0.0, 0.05, 1.5])
def test_range_search_matches_reference(carried, eps):
    X, Q, ja, jg, ta, tg = carried
    for q in Q[:3]:
        ql = ja.prepare_query_item(q, jg)
        ref, got = ja.range_search(q, ql, eps), ta.range_search(q, ql, eps)
        assert [i for i, _ in got] == [i for i, _ in ref]
        np.testing.assert_allclose([d for _, d in got], [d for _, d in ref], atol=1e-7, rtol=0)


def test_range_search_mask_is_signed_float32():
    lam = np.array([0.1, 0.5, 0.6, 0.9], np.float32)
    rd, rm = jsearch.range_search_mask(jnp.asarray(lam), jnp.float32(0.55), jnp.float32(0.05))
    gd, gm = tsearch.range_search_mask(torch.from_numpy(lam), torch.tensor(0.55), torch.tensor(0.05))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))


def _same_by_distance(ref, got, q_ref, q_got, tol=1e-6):
    """Equal lengths; position by position the |Δλ| agree within ``tol``,
    and ids may differ only there (each package takes its own query λ,
    which agree within an ulp, so near-equal distances may trade places)."""
    ri, rd = [i for i, _ in ref], [abs(l - q_ref) for _, l in ref]
    gi, gd = [i for i, _ in got], [abs(l - q_got) for _, l in got]
    assert not same_k_mismatches([ri], [-np.asarray(rd)], [gi], [-np.asarray(gd)], tol)


@pytest.mark.parametrize("k", [1, 5, 50])
def test_sorted_index_searches_match_reference(carried, k):
    X, Q, ja, jg, ta, tg = carried
    for q in Q[:4]:
        q_ref, q_got = ja.prepare_query_item(q, jg), ta.prepare_query_item(q, tg)
        assert abs(q_ref - q_got) <= 1e-6
        _same(ja.search_linear_sorted(q, jg, k), ta.search_linear_sorted(q, tg, k), 1e-6)
        _same_by_distance(ja.search_k_nearest_by_lambda(q, jg, k),
                          ta.search_k_nearest_by_lambda(q, tg, k), q_ref, q_got)
        _same_by_distance(ja.search_k_nearest_by_lambda(q, jg, k, base_delta=1e-4, growth=3.0),
                          ta.search_k_nearest_by_lambda(q, tg, k, base_delta=1e-4, growth=3.0),
                          q_ref, q_got)
        # At the same query λ the two indexes answer alike.
        for delta in (None, 1e-4):
            _same(ja.lambdas_sorted.k_nearest_by_lambda(q_ref, k, 2.0, delta),
                  ta.lambdas_sorted.k_nearest_by_lambda(q_ref, k, 2.0, delta), 0.0)


def test_device_sorted_index_host_view_matches_reference():
    lam = np.random.default_rng(2).random(300).astype(np.float32)
    lam[::7] = lam[3]
    ref = JDeviceSorted.build_from(jnp.asarray(lam))
    got = DeviceSortedLambdas.build_from(torch.from_numpy(lam))
    assert got.to_vec() == ref.to_vec()
    for q, k, p in ((0.42, 5, 0.5), (lam[3], 9, 2.0), (0.0, 3, 1.0)):
        assert got.k_nearest_by_lambda(q, k, p) == ref.k_nearest_by_lambda(q, k, p)
    assert got._host_view() is got._host_view()


# ------------------------------------------- the reference's cases, the port


def test_hybrid_includes_semantic_top(built):
    aspace, gl, data = built
    q = data[7]
    res = aspace.search_lambda_aware_hybrid(q, aspace.prepare_query_item(q, gl), 5)
    assert any(i == 7 for i, _ in res)


def test_hybrid_matches_plain_on_small_k(built):
    aspace, gl, data = built
    q = data[11]
    lam = aspace.prepare_query_item(q, gl)
    plain = {i for i, _ in aspace.search_lambda_aware(q, lam, 3)}
    hybrid = {i for i, _ in aspace.search_lambda_aware_hybrid(q, lam, 3)}
    assert len(plain & hybrid) >= 1


def test_range_search(built):
    aspace, gl, data = built
    lam = aspace.prepare_query_item(data[2], gl)
    lamarr = aspace.lambdas.numpy()
    for i, d in aspace.range_search(data[2], lam, eps=0.1):
        assert lam - lamarr[i] <= 0.1 + 1e-6


def test_search_linear_sorted(built):
    aspace, gl, data = built
    res = aspace.search_linear_sorted(data[4], gl, 5)
    assert len(res) <= 5
    lamarr = aspace.lambdas.numpy()
    for i, l in res:
        assert l == pytest.approx(float(lamarr[i]), abs=1e-6)


def test_sorted_lambdas_roundtrip():
    lam = np.array([0.5, 0.1, 0.9, 0.1, 0.3])
    vec = SortedLambdas.build_from(lam).to_vec()
    assert [v for v, _ in vec] == sorted(lam.tolist())
    assert [i for v, i in vec if v == 0.1] == [1, 3]
    assert vec == JSorted.build_from(lam).to_vec()


def test_k_nearest_by_lambda_expanding():
    idx = SortedLambdas.build_from(np.linspace(0, 1, 50))
    out = idx.k_nearest_by_lambda(0.42, k=7, lambda_p=0.5)
    assert len(out) == 7
    dists = [abs(l - 0.42) for _, l in out]
    assert dists == sorted(dists)


def test_device_sorted_index_matches_host():
    lam = np.linspace(0, 1, 101)
    host = SortedLambdas.build_from(lam)
    dev = DeviceSortedLambdas.build_from(torch.from_numpy(lam))
    assert dev.std_dev == pytest.approx(host.std_dev, abs=1e-5)
    assert [i for i, _ in host.range_bylambda(0.5, 7, 2.0)] == \
        [i for i, _ in dev.range_bylambda(0.5, 7, 2.0)]
    assert [i for i, _ in host.k_nearest_by_lambda(0.42, 5, 0.5)] == \
        [i for i, _ in dev.k_nearest_by_lambda(0.42, 5, 0.5)]


def test_banded_search_converges_to_full_scan(built):
    aspace, gl, data = built
    q = data[25]
    q_lam = aspace.prepare_query_item(q, gl)
    full = aspace.search_lambda_aware(q, q_lam, 5)
    banded = aspace.search_lambda_banded(q, q_lam, 5, window=4096)
    assert [i for i, _ in full] == [i for i, _ in banded]
    for (_, a), (_, b) in zip(full, banded):
        assert a == pytest.approx(b, abs=1e-5)


def test_banded_search_small_window_self_retrieval(built):
    aspace, gl, data = built
    q = data[33]
    res = aspace.search_lambda_banded(q, aspace.prepare_query_item(q, gl), 3, window=16)
    assert res[0][0] == 33


def test_search_k_nearest_by_lambda(built):
    aspace, gl, data = built
    res = aspace.search_k_nearest_by_lambda(data[6], gl, 5)
    assert 1 <= len(res) <= 5
    q_lam = aspace.prepare_query_item(data[6], gl)
    dists = [abs(l - q_lam) for _, l in res]
    assert dists == sorted(dists)


def test_search_without_taumode_raises_clearly():
    data = make_gaussian_blob(60, 0.5).astype(np.float32)
    aspace = ArrowSpace.from_items(data, device=CPU)
    gl = lap.build_laplacian_from_k_cluster(
        torch.from_numpy(data[:8].copy()), GraphParams(eps=1.0, k=5, sparsity_check=False),
        n_items=len(data))
    for call in (lambda: aspace.search_lambda_aware_hybrid(data[3], 0.5, 5),
                 lambda: aspace.search_linear_sorted(data[3], gl, 5),
                 lambda: aspace.range_search(data[3], 0.5, 0.1)):
        with pytest.raises(RuntimeError, match="lambdas not computed"):
            call()
    for call in (lambda: aspace.search_lambda_banded(data[3], 0.5, 5),
                 lambda: aspace.search_k_nearest_by_lambda(data[3], gl, 5)):
        with pytest.raises(ValueError, match="build_lambdas_sorted"):
            call()


def test_lambda_aware_scores_range():
    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.normal(size=(30, 8)).astype(np.float32))
    norms = torch.sqrt(torch.sum(X * X, dim=-1))
    lams = torch.from_numpy(rng.random(30).astype(np.float32))
    s = tsearch.lambda_aware_scores(X, norms, lams, X[0], 0.5, 0.7).numpy()
    assert s.shape == (30,)
    assert (s <= 1.0 + 1e-6).all() and (s >= -1.0 - 1e-6).all()


def test_item_mutation_family():
    """``tests/test_api_surface.py::test_item_mutation_family`` on the port."""
    data = make_gaussian_blob(100, 0.4).astype(np.float32)
    aspace, gl = (TBuilder(device=CPU).with_lambda_graph(1.0, 5)
                  .with_cluster_params(max_clusters=8, radius=5.0)
                  .with_sparsity_check(False).build(data))
    c = aspace.cluster_of(3)
    assert c is None or 0 <= c < aspace.n_clusters
    assert aspace.cluster_of(10**6) is None
    lam_before = aspace.lambdas.numpy().copy()
    aspace.scale_item(5, 2.0, gl)
    np.testing.assert_allclose(aspace.data[5].numpy(), 2.0 * data[5], rtol=1e-6)
    aspace.mul_items(7, 8, gl)
    np.testing.assert_allclose(aspace.data[7].numpy(), data[7] * data[8], rtol=1e-5)
    lam_after = aspace.lambdas.numpy()
    assert lam_after.shape == lam_before.shape and np.isfinite(lam_after).all()
    with pytest.raises(ValueError, match="shape"):
        aspace.set_item(0, np.ones(3, np.float32))
    aspace.drop_data()
    assert aspace.data.shape == (0, aspace.nfeatures)
    assert aspace.lambdas.shape == (100,)
