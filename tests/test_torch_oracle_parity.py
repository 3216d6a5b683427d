"""The port held to the float64 oracles, as ``tests/test_reference_parity.py``
holds the reference: the same inputs, seeds and tolerances, with the port
built and searched on the CPU (``device="cpu"``, the kernels' plain
versions) against ``oracle.py`` and ``oracle_staged.py``, which the port
takes from the reference package.

Held: identical graph topology (nonzero pattern of W) and weights within
5e-6; λ within 2e-5 for every taumode; exact top-10 sets (19 of 20) and
Kendall-τ ≥ 0.99 over the top 50 on the full build, 9 of 10 shared at
α = 0.95; query λ within 1e-4; the oracle's recall equal to the port's
within 0.02; σ/p variants; dispersion within 1e-5; the energy pipeline; the
staged pipeline's trunk-aware / squared-Euclidean variant; hybrid search;
the sorted band. The staged pipeline's default chain (Euclidean MST) is
held by ``tests/test_torch_pipeline.py::test_chain_matches_the_staged_oracle``
with the reference's bounds. The oracle's own check
``test_oracle_fast_lambdas_match_scan`` tests the oracle and has no
counterpart here.
"""

import numpy as np
import pytest
import torch

from matternet_rs_tpu import oracle
from matternet_rs_tpu import oracle_staged as osg

from matternet_rs_tpu_torch import energymaps as em
from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder
from matternet_rs_tpu_torch.core import TauMode
from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.index.sorted import DeviceSortedLambdas, SortedLambdas
from matternet_rs_tpu_torch.ops import laplacian as lap_ops
from matternet_rs_tpu_torch.ops import taumode as tau_ops
from matternet_rs_tpu_torch.reduction import ImplicitProjection
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _clustered_rows(n, f, n_centers=8, seed=1, spread=3.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, f)) * spread
    return (centers[rng.integers(0, n_centers, n)] + rng.normal(size=(n, f))).astype(
        np.float32
    ), rng


def _sample_centroids(rows, c, seed=0):
    rng = np.random.default_rng(seed)
    n = rows.shape[0]
    return np.stack(
        [rows[rng.choice(n, 20, replace=False)].mean(0) for _ in range(c)]
    ).astype(np.float32)


def _kendall_tau(order_a, order_b):
    """Kendall-τ between two rankings restricted to their common items."""
    common = [i for i in order_a if i in set(order_b)]
    ra = {i: r for r, i in enumerate(order_a)}
    rb = {i: r for r, i in enumerate(order_b)}
    xs = [ra[i] for i in common]
    ys = [rb[i] for i in common]
    n = len(common)
    if n < 2:
        return 1.0
    concordant = discordant = 0
    for i in range(n):
        for j in range(i + 1, n):
            s = (xs[i] - xs[j]) * (ys[i] - ys[j])
            if s > 0:
                concordant += 1
            elif s < 0:
                discordant += 1
    denom = concordant + discordant
    return 1.0 if denom == 0 else (concordant - discordant) / denom


def test_oracle_dispersion_matches_port():
    rows, _ = _clustered_rows(40, 16, seed=5)
    cents = _sample_centroids(rows, 12, seed=6)
    _, L = oracle.build_laplacian_from_centroids(cents, 0.9, 5, 2.0, None, False)
    for row in rows[:10]:
        g_or = oracle.item_dispersion(row, L)
        g_port = float(tau_ops.item_dispersion(_t(row), _t(L)))
        assert abs(g_or - g_port) < 1e-5


@pytest.mark.parametrize("normalise", [False, True])
@pytest.mark.parametrize("eps,topk", [(0.9, 8), (0.5, 5)])
def test_graph_topology_identical(normalise, eps, topk):
    rows, _ = _clustered_rows(400, 48, seed=11)
    cents = _sample_centroids(rows, 40, seed=12)
    params = GraphParams(eps=eps, k=topk, topk=topk, p=2.0, sigma=None,
                         normalise=normalise, sparsity_check=False)
    W_port = _np(lap_ops.build_adjacency(_t(cents).T, params))
    W_or = oracle.build_adjacency(cents.T, eps, topk, 2.0, None, normalise)
    t_port, t_or = W_port > 0, W_or > 0
    assert (t_port ^ t_or).sum() == 0, "graph topology diverged"
    np.testing.assert_allclose(
        np.where(t_port, W_port, 0.0), np.where(t_or, W_or, 0.0), atol=5e-6
    )


@pytest.mark.parametrize("taumode,otau", [
    (TauMode.median(), ("median", 0.0)),
    (TauMode.mean(), ("mean", 0.0)),
    (TauMode.fixed(0.3), ("fixed", 0.3)),
    (TauMode.percentile(0.9), ("percentile", 0.9)),
])
def test_lambda_parity_f32_tolerance(taumode, otau):
    rows, _ = _clustered_rows(600, 48, seed=21)
    cents = _sample_centroids(rows, 40, seed=22)
    params = GraphParams(eps=0.9, k=8, topk=8, p=2.0, sigma=None,
                         normalise=False, sparsity_check=False)
    gl = lap_ops.build_laplacian_from_k_cluster(_t(cents), params, n_items=len(rows))
    raw_port = _np(tau_ops.taumode_lambdas(_t(rows), gl.matrix, taumode.mode, taumode.param))
    oi = oracle.build_index(rows, cents, eps=0.9, topk=8, tau_mode=otau[0],
                            tau_param=otau[1], fast_lambdas=True)
    np.testing.assert_allclose(raw_port, oi.raw_lambdas, atol=2e-5)


def _parity_build(n=1000, f=64, seed=1, alpha=0.7):
    rows, rng = _clustered_rows(n, f, seed=seed)
    sub = rows[:200]
    radius = float(
        np.quantile(np.sum((sub[:, None] - sub[None, :]) ** 2, -1), 0.05)
    )
    b = (
        ArrowSpaceBuilder(device=CPU)
        .with_lambda_graph(0.9, 8, 2.0, None)
        .with_cluster_params(max_clusters=48, radius=radius)
        .with_seed(7)
        .with_deterministic_clustering(True)
        .with_sampling(None)
    )
    aspace, gl = b.build(rows)
    oc_cents, _ = oracle.incremental_clustering(rows, b.cluster_max_clusters, b.cluster_radius)
    oi = oracle.build_index(
        rows, oc_cents, eps=b.lambda_eps, topk=b.lambda_topk, p=b.lambda_p,
        sigma=b.lambda_sigma, normalise=b.normalise, fast_lambdas=True,
    )
    return rows, rng, aspace, gl, oi, alpha


def test_full_build_ranking_parity():
    rows, rng, aspace, gl, oi, alpha = _parity_build()

    assert aspace.n_clusters == len(oi.centroids)
    np.testing.assert_allclose(_np(aspace.lambdas), oi.lambdas, atol=2e-5)

    n = rows.shape[0]
    queries = rows[rng.choice(n, 20, replace=False)] + 0.1 * rng.normal(
        size=(20, rows.shape[1])
    ).astype(np.float32)
    exact_matches = 0
    for q in queries.astype(np.float32):
        ql_port = aspace.prepare_query_item(q, gl)
        ql_or = oi.prepare_query(q)
        assert abs(ql_port - ql_or) < 1e-4, "query-λ preparation diverged"

        top10_port = {i for i, _ in aspace.search_lambda_aware(q, ql_port, 10, alpha)}
        top10_or = {i for i, _ in oi.search(q, 10, alpha)}
        exact_matches += top10_port == top10_or

        order_port = [i for i, _ in aspace.search_lambda_aware(q, ql_port, 50, alpha)]
        order_or = [i for i, _ in oi.search(q, 50, alpha)]
        assert _kendall_tau(order_port, order_or) >= 0.99

    assert exact_matches >= 19, f"only {exact_matches}/20 exact top-10 set matches"


def test_full_build_ranking_parity_alpha_095():
    rows, rng, aspace, gl, oi, _ = _parity_build(seed=2)
    n = rows.shape[0]
    queries = rows[rng.choice(n, 10, replace=False)]
    for q in queries.astype(np.float32):
        ql = aspace.prepare_query_item(q, gl)
        top10_port = {i for i, _ in aspace.search_lambda_aware(q, ql, 10, 0.95)}
        top10_or = {i for i, _ in oi.search(q, 10, 0.95)}
        assert len(top10_port & top10_or) >= 9


def test_oracle_recall_matches_port_recall():
    """The λ blend's recall against pure-cosine ground truth is a property
    of the formula: the oracle and the port score the same recall@10."""
    rows, rng, aspace, gl, oi, alpha = _parity_build(n=1200, seed=3)
    n = rows.shape[0]
    q_idx = rng.choice(n, 25, replace=False)
    queries = (rows[q_idx] + 0.05 * rng.normal(size=(25, rows.shape[1]))).astype(np.float32)

    Xn = rows.astype(np.float64)
    Xn /= np.maximum(np.linalg.norm(Xn, axis=1, keepdims=True), 1e-12)

    def recall(top10_fn):
        hits = total = 0
        for q in queries:
            qn = q.astype(np.float64)
            qn /= max(np.linalg.norm(qn), 1e-12)
            gt = set(np.argsort(-(Xn @ qn), kind="stable")[:10].tolist())
            hits += len(gt & top10_fn(q))
            total += 10
        return hits / total

    r_port = recall(
        lambda q: {
            i for i, _ in aspace.search_lambda_aware(
                q, aspace.prepare_query_item(q, gl), 10, alpha
            )
        }
    )
    r_or = recall(lambda q: {i for i, _ in oi.search(q, 10, alpha)})
    assert abs(r_port - r_or) <= 0.02, (r_port, r_or)


@pytest.mark.parametrize("sigma,p", [(0.1, 2.0), (0.5, 1.0), (None, 3.0)])
def test_sigma_and_p_variants_parity(sigma, p):
    rows, _ = _clustered_rows(300, 32, seed=31)
    cents = _sample_centroids(rows, 24, seed=32)
    params = GraphParams(eps=0.9, k=6, topk=6, p=p, sigma=sigma,
                         normalise=False, sparsity_check=False)
    W_port = _np(lap_ops.build_adjacency(_t(cents).T, params))
    W_or = oracle.build_adjacency(cents.T, 0.9, 6, p, sigma, False)
    assert ((W_port > 0) ^ (W_or > 0)).sum() == 0
    np.testing.assert_allclose(W_port, W_or, atol=5e-6)


def test_energy_pipeline_parity():
    """The energy build against the f64 oracle from the same stage-1 state
    and the same materialised projections: sub-centroids, their λ, the
    item assignment and the λ-distance search."""
    rows = make_energy_test_dataset(400, 96, seed=6).astype(np.float32)
    b = (
        ArrowSpaceBuilder(device=CPU)
        .with_seed(11)
        .with_lambda_graph(1.0, 6)
        .with_sparsity_check(False)
        .with_cluster_params(max_clusters=60, radius=25.0)
        .with_dims_reduction(True)
        .with_sampling(None)
        .with_expected_items(len(rows))
    )
    aspace, gl_energy = b.build_energy(rows)
    p = em.EnergyParams.from_builder(b)

    oc_cents, _ = oracle.incremental_clustering(
        rows, b.cluster_max_clusters, b.cluster_radius
    )
    proj = None
    if aspace.projection is not None:
        proj = _np(aspace.projection.matrix(device=CPU)).astype(np.float64)
        oc_cents = oc_cents @ proj
    fdim = oc_cents.shape[1]
    proj2d = _np(
        ImplicitProjection(fdim, 2, b.clustering_seed or 0).matrix(device=CPU)
    ).astype(np.float64)
    oi = oracle.build_energy_index(
        rows, oc_cents,
        eps=b.lambda_eps, k=b.lambda_k, topk=b.lambda_topk,
        optical_tokens=p.optical_tokens, trim_quantile=p.trim_quantile,
        eta=p.eta, steps=p.steps, split_quantile=p.split_quantile,
        neighbor_k=p.neighbor_k, split_tau=p.split_tau,
        proj2d=proj2d, projection=proj, normalise=b.normalise,
    )

    sc_port = _np(aspace.sub_centroids)
    assert sc_port.shape == oi.sub_centroids.shape, (sc_port.shape, oi.sub_centroids.shape)
    np.testing.assert_allclose(sc_port, oi.sub_centroids, atol=5e-4)
    np.testing.assert_allclose(
        _np(aspace.subcentroid_lambdas), oi.subcentroid_lambdas, atol=2e-4
    )
    agree = float(np.mean(_np(aspace.centroid_map) == oi.centroid_map))
    assert agree >= 0.99, f"centroid_map agreement {agree}"

    rng = np.random.default_rng(4)
    for qi in rng.integers(0, len(rows), 8):
        q = rows[qi]
        res_port = [i for i, _ in em.search_energy(aspace, q, gl_energy, 10)]
        res_or = [i for i, _ in oi.search(q, 10, projection=proj)]
        assert res_port[0] == res_or[0]
        assert len(set(res_port) & set(res_or)) >= 9, (res_port, res_or)


def test_staged_pipeline_parity_trunk_aware_sqeuclidean():
    """The staged chain's variants against the oracle: a squared-Euclidean
    MST metric with geometric-mean thickness, and trunk-aware RTS."""
    from matternet_rs_tpu_torch.pipeline.centroid import CentroidState
    from matternet_rs_tpu_torch.pipeline.clustering import ClusteringConfig, ClusteringStage
    from matternet_rs_tpu_torch.pipeline.mst import MSTConfig, MSTStage
    from matternet_rs_tpu_torch.pipeline.preflight import PreflightConfig, PreflightStage
    from matternet_rs_tpu_torch.pipeline.smoothing import SmoothingConfig, SmoothingStage

    rows, _ = _clustered_rows(300, 16, seed=12, spread=4.0)
    a_out = ClusteringStage(
        ClusteringConfig(max_clusters=20, radius_threshold=30.0), device=CPU
    ).execute(rows)
    b0 = PreflightStage(PreflightConfig()).execute(a_out.state)
    state = CentroidState(
        means=b0.normalized_centroids, variances=b0.variances, counts=a_out.state.counts,
    )
    cfg = MSTConfig(distance_metric="sqeuclidean", thickness_weight="geometric_mean")
    mst = MSTStage(cfg).execute(state)
    kal = SmoothingStage(SmoothingConfig.trunk_aware(0.3)).execute(state, mst)

    res_mst = osg.mst_stage(
        _np(b0.normalized_centroids).astype(np.float64),
        _np(b0.variances).astype(np.float64),
        distance_metric="sqeuclidean", thickness_weight="geometric_mean",
    )
    assert {frozenset((e.u, e.v)) for e in mst.mst_edges} == {
        frozenset((u, v)) for u, v, _ in res_mst.mst_edges
    }
    np.testing.assert_array_equal(mst.centroid_order, res_mst.centroid_order)

    order = res_mst.centroid_order
    trunk_flags = np.zeros(len(order), bool)
    for t in range(1, len(order)):
        trunk_flags[t] = (int(order[t - 1]), int(order[t])) in res_mst.trunk_edges
    sm, sv = osg.kalman_rts(
        _np(b0.normalized_centroids).astype(np.float64)[order],
        _np(b0.variances).astype(np.float64)[order],
        trunk_flags, transition_model="trunk_aware", trunk_factor=0.3,
    )
    np.testing.assert_allclose(_np(kal.smoothed_means), sm, atol=1e-4)
    np.testing.assert_allclose(_np(kal.smoothed_variances), sv, atol=1e-5)


def test_hybrid_search_parity():
    """Hybrid search (λ top-k ∪ high-cosine ∪ semantic top-1, cosine
    first) against the oracle, on self-queries and perturbed ones."""
    rows, rng, aspace, gl, oi, _ = _parity_build(n=800, seed=5)
    n = rows.shape[0]
    q_ids = rng.choice(n, 6, replace=False)
    queries = np.concatenate(
        [rows[q_ids], rows[q_ids] + 0.05 * rng.normal(size=(6, rows.shape[1])).astype(np.float32)]
    )
    for q in queries.astype(np.float32):
        ql = aspace.prepare_query_item(q, gl)
        res_port = aspace.search_lambda_aware_hybrid(q, ql, 10)
        res_or = oracle.search_lambda_aware_hybrid(
            rows, oi.lambdas, q, oi.prepare_query(q), 10, 0.7
        )
        ids_port = [i for i, _ in res_port]
        ids_or = [i for i, _ in res_or]
        assert ids_port[0] == ids_or[0]
        assert len(set(ids_port) & set(ids_or)) >= len(ids_or) - 1, (ids_port, ids_or)


@pytest.mark.parametrize("q,k,p", [(0.5, 10, 2.0), (0.03, 5, 1.0), (0.97, 20, 3.0)])
def test_sorted_index_band_query_parity(q, k, p):
    """The band query and the expanding-window k-nearest over the sorted-λ
    index, host and device forms, against the oracle."""
    rng = np.random.default_rng(13)
    lam = rng.random(500).astype(np.float32)
    host = SortedLambdas.build_from(lam)
    dev = DeviceSortedLambdas.build_from(torch.from_numpy(lam))

    expect = oracle.sorted_band_query(lam, q, k, p)
    got_h = host.range_bylambda(q, k, p)
    got_d = dev.range_bylambda(q, k, p)
    assert [i for i, _ in got_h] == [i for i, _ in expect]
    assert [i for i, _ in got_d] == [i for i, _ in expect]
    np.testing.assert_allclose([v for _, v in got_h], [v for _, v in expect], atol=1e-6)

    expect_k = oracle.k_nearest_by_lambda(lam, q, k, p)
    assert [i for i, _ in host.k_nearest_by_lambda(q, k, p)] == [i for i, _ in expect_k]
    assert [i for i, _ in dev.k_nearest_by_lambda(q, k, p)] == [i for i, _ in expect_k]
