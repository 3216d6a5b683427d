"""Retrieval quality of the port, the checks of
``tests/test_retrieval_quality.py`` with its fixtures, seeds and bounds, on
the port built and searched on the CPU (``device="cpu"``): energy against
standard precision@k and same-cluster recall, the λ distributions, energy's
independence from cosine, prefix stability over k, batched against serial,
projection on and off, the query errors, the JL projection's distance,
linearity and sign properties, the λ blend against pure cosine, the same
comparisons at N = 5,000 (distributed energy routing on the port's 8-slot
CPU mesh, a device listed 8 times); and the checks of
``tests/test_energy_search_quality_5k.py`` at N = 6,000, F = 32."""

import time

import numpy as np
import pytest

from matternet_rs_tpu_torch import energymaps as em
from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder
from matternet_rs_tpu_torch.core import TauMode
from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.parallel import make_mesh
from matternet_rs_tpu_torch.parallel.index import ShardedArrowSpace
from matternet_rs_tpu_torch.reduction import ImplicitProjection, project_matrix
from matternet_rs_tpu_torch.utils.fixtures import (
    make_cosine_tied_smoothness_dataset,
    make_energy_test_dataset,
)

CPU = "cpu"
N, F, K = 300, 100, 10
N_CLUSTERS = 5   # make_energy_test_dataset is the 5-cluster fixture


def _cluster_of(i: int) -> int:
    return i * N_CLUSTERS // N     # the fixture lays clusters out contiguously


def _np(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


@pytest.fixture(scope="module")
def dataset():
    return make_energy_test_dataset(N, F, seed=42).astype(np.float32)


@pytest.fixture(scope="module")
def standard(dataset):
    b = (
        ArrowSpaceBuilder(device=CPU)
        .with_seed(111)
        .with_lambda_graph(1.0, 6)
        .with_sparsity_check(False)
        .with_cluster_params(max_clusters=30, radius=25.0)
        .with_sampling(None)
    )
    return b.build(dataset) + (b,)


@pytest.fixture(scope="module")
def energy(dataset):
    b = (
        ArrowSpaceBuilder(device=CPU)
        .with_seed(111)
        .with_lambda_graph(1.0, 6)
        .with_sparsity_check(False)
        .with_cluster_params(max_clusters=30, radius=25.0)
        .with_dims_reduction(True)
        .with_sampling(None)
        .with_expected_items(N)
    )
    return b.build_energy(dataset) + (b,)


def _euclidean_gt(dataset, query, k):
    d = np.linalg.norm(dataset.astype(np.float64) - query.astype(np.float64), axis=1)
    return set(np.argsort(d, kind="stable")[:k].tolist())


def _std_top(aspace, gl, q, k=K, alpha=0.7):
    return [i for i, _ in aspace.search_lambda_aware(q, aspace.prepare_query_item(q, gl), k,
                                                     alpha)]


def test_energy_vs_standard_precision_at_k(dataset, standard, energy):
    aspace_std, gl_std, _ = standard
    aspace_en, gl_en, _ = energy
    q_ids = [34, 120, 250]
    p_std = np.mean([
        len(set(_std_top(aspace_std, gl_std, dataset[qi])) & _euclidean_gt(dataset, dataset[qi], K))
        / K for qi in q_ids
    ])
    p_en = np.mean([
        len({i for i, _ in em.search_energy(aspace_en, dataset[qi], gl_en, K)}
            & _euclidean_gt(dataset, dataset[qi], K)) / K
        for qi in q_ids
    ])
    assert p_std >= 0.5, f"standard precision@10 = {p_std}"
    assert p_en > K / N, f"energy precision@10 = {p_en} is at/below chance"


def test_energy_vs_standard_same_cluster_recall(dataset, standard, energy):
    aspace_std, gl_std, _ = standard
    aspace_en, gl_en, _ = energy

    def cluster_recall(top_fn):
        return float(np.mean([
            np.mean([(_cluster_of(i) == _cluster_of(qi)) for i in top_fn(dataset[qi])])
            for qi in (10, 100, 170, 290)
        ]))

    r_std = cluster_recall(lambda q: _std_top(aspace_std, gl_std, q))
    r_en = cluster_recall(lambda q: [i for i, _ in em.search_energy(aspace_en, q, gl_en, K)])
    assert r_std >= 0.8, f"standard same-cluster recall = {r_std}"
    assert r_en > 1.0 / N_CLUSTERS + 0.1, f"energy same-cluster recall = {r_en}"


def test_energy_vs_standard_lambda_distribution(standard, energy):
    aspace_std, _, _ = standard
    aspace_en, _, _ = energy
    lam_std = _np(aspace_std.lambdas)
    lam_en = _np(aspace_en.lambdas)
    for lam in (lam_std, lam_en):
        assert lam.min() >= 0.0 and lam.max() <= 1.0
        assert lam.max() - lam.min() > 0.0
    # Energy λ is inherited from the sub-centroids.
    assert len(np.unique(lam_en)) <= aspace_en.sub_centroids.shape[0]
    assert len(np.unique(lam_std)) > len(np.unique(lam_en))


def test_energy_no_cosine_dependence(dataset, energy):
    aspace, gl_energy, _ = energy
    q = dataset[5]
    res = em.search_energy(aspace, q, gl_energy, K)
    q_lambda = aspace.prepare_query_item(q, gl_energy)
    lam = _np(aspace.lambdas)

    lam_dists = [abs(q_lambda - float(lam[i])) for i, _ in res]
    scores = [s for _, s in res]
    assert scores == sorted(scores)
    assert lam_dists == sorted(lam_dists) or max(
        abs(a - b) for a, b in zip(lam_dists, sorted(lam_dists))
    ) < 1e-6

    X = _np(aspace.data).astype(np.float64)
    qv = q.astype(np.float64)
    cos = [float(X[i] @ qv / (np.linalg.norm(X[i]) * np.linalg.norm(qv))) for i, _ in res]
    if len(set(np.round(lam_dists, 12))) > 1:
        assert cos != sorted(cos, reverse=True), (
            "energy results are cosine-ordered — λ is not driving the ranking"
        )


def test_energy_k_scaling_prefix_stable(dataset, energy):
    aspace, gl_energy, _ = energy
    q = dataset[42]
    prev = []
    for k in (1, 3, 5, 10, 20):
        res = [i for i, _ in em.search_energy(aspace, q, gl_energy, k)]
        assert res[: len(prev)] == prev
        prev = res


def test_energy_batched_matches_serial(dataset, energy):
    aspace, gl_energy, _ = energy
    Q = dataset[[7, 77, 177]]
    idx, dist = em.search_energy_batch(aspace, Q, gl_energy, K)
    for r, qi in enumerate([7, 77, 177]):
        serial = em.search_energy(aspace, dataset[qi], gl_energy, K)
        assert _np(idx[r]).tolist() == [i for i, _ in serial]
        np.testing.assert_allclose(_np(dist[r]), [d for _, d in serial], atol=1e-6)


@pytest.fixture(scope="module")
def projected_build():
    data = make_energy_test_dataset(400, 256, seed=7).astype(np.float32)
    b = (
        ArrowSpaceBuilder(device=CPU)
        .with_seed(13)
        .with_lambda_graph(1.0, 6)
        .with_sparsity_check(False)
        .with_cluster_params(max_clusters=120, radius=25.0)
        .with_dims_reduction(True)
        .with_sampling(None)
    )
    aspace, gl = b.build(data)
    return data, aspace, gl


def test_query_with_projection_enabled(projected_build):
    data, aspace, gl = projected_build
    # The reference skips where JL does not engage; at this configuration
    # it engages in both packages.
    assert aspace.projection is not None
    ql = aspace.prepare_query_item(data[11], gl)
    assert 0.0 <= ql <= 1.0
    res = aspace.search_lambda_aware(data[11], ql, 5)
    assert res[0][0] == 11


def test_prepare_query_item_deterministic(projected_build):
    data, aspace, gl = projected_build
    assert aspace.prepare_query_item(data[3], gl) == aspace.prepare_query_item(data[3], gl)


def test_query_with_without_projection_consistency():
    """The same data built with and without JL: pure cosine (α = 1) agrees
    on 9 of the top 10, and self-retrieval survives at every blend."""
    data = make_energy_test_dataset(300, 256, seed=8).astype(np.float32)

    def build(reduce: bool):
        b = (
            ArrowSpaceBuilder(device=CPU)
            .with_seed(21)
            .with_lambda_graph(1.0, 6)
            .with_sparsity_check(False)
            .with_cluster_params(max_clusters=100, radius=25.0)
            .with_dims_reduction(reduce)
            .with_sampling(None)
        )
        return b.build(data)

    aspace_p, gl_p = build(True)
    aspace_n, gl_n = build(False)
    rng = np.random.default_rng(3)
    for qi in rng.integers(0, data.shape[0], 6):
        q = data[qi]
        t1_p = _std_top(aspace_p, gl_p, q, alpha=1.0)
        t1_n = _std_top(aspace_n, gl_n, q, alpha=1.0)
        assert len(set(t1_p) & set(t1_n)) >= 9, (t1_p, t1_n)
        for alpha in (0.7, 0.95):
            tp = _std_top(aspace_p, gl_p, q, alpha=alpha)
            tn = _std_top(aspace_n, gl_n, q, alpha=alpha)
            assert tp[0] == tn[0] == qi


def test_query_dimension_mismatch_raises(projected_build):
    data, aspace, gl = projected_build
    with pytest.raises(ValueError, match="dimension"):
        aspace.prepare_query_item(np.ones(17, np.float32), gl)


def test_query_nan_raises(projected_build):
    data, aspace, gl = projected_build
    q = data[0].copy()
    q[3] = np.nan
    with pytest.raises(ValueError, match="finite"):
        aspace.prepare_query_item(q, gl)


def test_jl_projection_preserves_pairwise_distances():
    rng = np.random.default_rng(17)
    n, f, r = 400, 512, 128
    X = rng.normal(size=(n, f)).astype(np.float32)
    proj = ImplicitProjection(f, r, seed=5)
    Y = _np(project_matrix(X, proj, device=CPU))

    pairs = rng.integers(0, n, size=(500, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    d_orig = np.linalg.norm(X[pairs[:, 0]] - X[pairs[:, 1]], axis=1)
    d_proj = np.linalg.norm(Y[pairs[:, 0]] - Y[pairs[:, 1]], axis=1)
    ratio = d_proj / d_orig
    assert abs(float(ratio.mean()) - 1.0) < 0.05
    assert float(ratio.std()) < 0.15
    assert float(np.quantile(ratio, 0.99)) < 1.5
    assert float(np.quantile(ratio, 0.01)) > 0.6


def test_jl_projection_linearity_and_determinism():
    proj = ImplicitProjection(64, 32, seed=9)
    rng = np.random.default_rng(0)
    a = rng.normal(size=64).astype(np.float32)
    b = rng.normal(size=64).astype(np.float32)
    pa = _np(proj.project(a, CPU))
    pb = _np(proj.project(b, CPU))
    np.testing.assert_allclose(_np(proj.project(a + b, CPU)), pa + pb, atol=1e-4)
    np.testing.assert_allclose(_np(proj.project(2.5 * a, CPU)), 2.5 * pa, atol=1e-4)
    # Seed-only persistence: a reconstructed projection is bit-identical.
    np.testing.assert_array_equal(pa, _np(ImplicitProjection(64, 32, seed=9).project(a, CPU)))
    assert np.any(_np(ImplicitProjection(64, 32, seed=10).project(a, CPU)) != pa)


def test_jl_preserves_dot_product_sign_statistically():
    rng = np.random.default_rng(23)
    f, r = 256, 96
    proj = ImplicitProjection(f, r, seed=4)
    agree = 0
    trials = 200
    for _ in range(trials):
        a = rng.normal(size=f).astype(np.float32)
        b = rng.normal(size=f).astype(np.float32)
        if abs(a @ b) < 0.05 * np.linalg.norm(a) * np.linalg.norm(b):
            agree += 1  # undecided counts as agreement, as in the reference
            continue
        pa, pb = _np(proj.project(a, CPU)), _np(proj.project(b, CPU))
        agree += (a @ b > 0) == (float(pa @ pb) > 0)
    assert agree / trials > 0.8


@pytest.fixture(scope="module")
def smoothness_build():
    X, labels, styles = make_cosine_tied_smoothness_dataset(seed=0)
    aspace, gl = (
        ArrowSpaceBuilder(device=CPU)
        .with_lambda_graph(1.0, 6)
        .with_sparsity_check(False)
        .with_synthesis(TauMode.fixed(0.5))
        .with_cluster_params(max_clusters=80, radius=30.0)
        .with_sampling(None)
        .build(X)
    )
    return X, labels, styles, aspace, gl


def _style_precision(X, labels, styles, aspace, gl, alpha, seed=99):
    """precision@10 for same-direction smooth items, querying a noisy
    smooth item; rough items of the same direction are cosine-tied
    distractors that only λ can reject."""
    rng = np.random.default_rng(seed)
    ps = []
    for m in range(labels.max() + 1):
        rel = np.nonzero((labels == m) & (styles == 0))[0]
        q = X[rel[0]] + rng.normal(0, 0.03, X.shape[1]).astype(np.float32)
        ql = aspace.prepare_query_item(q, gl)
        res = aspace.search_lambda_aware(q, ql, K, alpha=alpha)
        ps.append(len({i for i, _ in res} & set(rel.tolist())) / K)
    return float(np.mean(ps))


def test_lambda_blend_beats_pure_cosine(smoothness_build):
    X, labels, styles, aspace, gl = smoothness_build
    p_cos = _style_precision(X, labels, styles, aspace, gl, alpha=1.0)
    p_blend = _style_precision(X, labels, styles, aspace, gl, alpha=0.7)
    assert p_cos < 0.60, f"cosine baseline unexpectedly strong: {p_cos}"
    assert p_blend >= p_cos + 0.05, f"λ blend did not help: cosine={p_cos:.3f} blend={p_blend:.3f}"


def test_lambda_separates_styles(smoothness_build):
    _, _, styles, aspace, _ = smoothness_build
    lam = _np(aspace.lambdas)
    rough = lam[styles == 1]
    assert rough.std() < 0.15, f"rough λ spread {rough.std():.3f}"
    smooth = lam[styles == 0]
    assert abs(np.median(smooth) - np.median(rough)) > 0.1


# The same comparisons at N = 5,000, F = 128.

N_LG, F_LG = 5000, 128


@pytest.fixture(scope="module")
def dataset_lg():
    return make_energy_test_dataset(N_LG, F_LG, seed=7).astype(np.float32)


@pytest.fixture(scope="module")
def standard_lg(dataset_lg):
    b = (
        ArrowSpaceBuilder(device=CPU)
        .with_seed(111)
        .with_lambda_graph(1.0, 6)
        .with_sparsity_check(False)
        .with_cluster_params(max_clusters=48, radius=25.0)
        .with_sampling(None)
    )
    return b.build(dataset_lg) + (b,)


@pytest.fixture(scope="module")
def energy_lg(dataset_lg):
    b = (
        ArrowSpaceBuilder(device=CPU)
        .with_seed(111)
        .with_lambda_graph(1.0, 6)
        .with_sparsity_check(False)
        .with_cluster_params(max_clusters=48, radius=25.0)
        .with_dims_reduction(True)
        .with_sampling(None)
        .with_expected_items(N_LG)
    )
    return b.build_energy(dataset_lg) + (b,)


def test_energy_vs_standard_precision_at_k_large(dataset_lg, standard_lg, energy_lg):
    aspace_std, gl_std, _ = standard_lg
    aspace_en, gl_en, _ = energy_lg
    q_ids = [34, 1200, 2500, 3900, 4700]

    def p_std(alpha):
        return np.mean([
            len(set(_std_top(aspace_std, gl_std, dataset_lg[qi], alpha=alpha))
                & _euclidean_gt(dataset_lg, dataset_lg[qi], K)) / K
            for qi in q_ids
        ])

    p_en = np.mean([
        len({i for i, _ in em.search_energy(aspace_en, dataset_lg[qi], gl_en, K)}
            & _euclidean_gt(dataset_lg, dataset_lg[qi], K)) / K
        for qi in q_ids
    ])
    assert p_std(0.7) >= 0.25, f"blended precision@10 = {p_std(0.7)}"
    assert p_std(0.95) >= p_std(0.7) - 1e-9
    Xn = dataset_lg / np.maximum(np.linalg.norm(dataset_lg, axis=1, keepdims=True), 1e-12)

    def cosine_gt(qi):
        return set(np.argsort(-(Xn @ Xn[qi]), kind="stable")[:K].tolist())

    p_cos = np.mean([
        len(set(_std_top(aspace_std, gl_std, dataset_lg[qi], alpha=1.0)) & cosine_gt(qi)) / K
        for qi in q_ids
    ])
    assert p_cos >= 0.9, f"pure-cosine precision vs cosine GT = {p_cos}"
    assert p_en > K / N_LG, f"energy precision@10 = {p_en} at/below chance"


def test_energy_lambda_distribution_nondegenerate_large(energy_lg):
    aspace_en, _gl, _ = energy_lg
    lam = _np(aspace_en.lambdas)
    assert lam.shape[0] == N_LG
    assert np.all(np.isfinite(lam)) and np.all((lam >= 0) & (lam <= 1))
    assert lam.std() > 1e-4
    assert aspace_en.sub_centroids.shape[0] >= 16


def test_same_cluster_recall_large(dataset_lg, standard_lg):
    aspace_std, gl_std, _ = standard_lg
    per = N_LG // N_CLUSTERS
    hits = []
    for qi in (100, 1500, 2600, 3700, 4900):
        got = set(_std_top(aspace_std, gl_std, dataset_lg[qi], alpha=0.7))
        cluster = qi // per
        hits.append(sum(cluster * per <= i < (cluster + 1) * per for i in got) / K)
    assert np.mean(hits) >= 0.8, f"same-cluster recall {np.mean(hits)}"


def test_distributed_energy_routing_large(dataset_lg):
    """Distributed energy λ routing at N = 5,000 on 8 CPU slots: valid λ
    for every shard row, energy self-queries win, λ distances ascend."""
    params = GraphParams(eps=1.0, k=6, topk=6, sparsity_check=False)
    sa = ShardedArrowSpace.distributed_build(
        [dataset_lg[:1700], dataset_lg[1700:3400], dataset_lg[3400:]],
        params, k_clusters=32, mesh=make_mesh(8, devices=[CPU] * 8),
    )
    lam = _np(sa.lambdas.gather())[:N_LG]
    assert np.all(np.isfinite(lam)) and np.all((lam >= 0) & (lam <= 1))
    for qi in (5, 2222, 4999):
        eres = sa.search_energy(dataset_lg[qi], k=5)
        assert eres[0][0] == qi, f"energy self-query lost at {qi}: {eres[:3]}"
        dists = [d for _, d in eres]
        assert dists == sorted(dists)


# Energy retrieval at N = 6,000, F = 32 (tests/test_energy_search_quality_5k.py).

N_5K, F_5K = 6000, 32
PER_5K = N_5K // 5                 # the fixture: 5 clusters, items in order


@pytest.fixture(scope="module")
def built_5k():
    data = make_energy_test_dataset(N_5K, F_5K, seed=7).astype(np.float32)
    labels = np.minimum(np.arange(N_5K) // PER_5K, 4)
    b = (
        ArrowSpaceBuilder(device=CPU)
        .with_lambda_graph(1.0, 5)
        .with_sparsity_check(False)
        .with_cluster_params(max_clusters=40, radius=16.0)
        .with_deterministic_clustering(True)
        .with_dims_reduction(True)
        .with_expected_items(N_5K)
        .with_seed(11)
    )
    t0 = time.perf_counter()
    aspace, gl = b.build_energy(data)
    energy_build_s = time.perf_counter() - t0
    return aspace, gl, data, labels, energy_build_s


@pytest.fixture(scope="module")
def eigen_built_5k():
    data = make_energy_test_dataset(N_5K, F_5K, seed=7).astype(np.float32)
    b = (
        ArrowSpaceBuilder(device=CPU)
        .with_lambda_graph(1.0, 5)
        .with_sparsity_check(False)
        .with_cluster_params(max_clusters=40, radius=16.0)
        .with_deterministic_clustering(True)
        .with_seed(11)
    )
    t0 = time.perf_counter()
    aspace, gl = b.build(data)
    eigen_build_s = time.perf_counter() - t0
    return aspace, gl, eigen_build_s


def test_energy_self_retrieval_at_scale(built_5k):
    aspace, gl, data, _labels, _ = built_5k
    rng = np.random.default_rng(3)
    probe = rng.integers(0, N_5K, 128)
    idx, _ = em.search_energy_batch(aspace, data[probe], gl, K)
    idx = _np(idx)
    hits = np.mean([p in idx[r].tolist() for r, p in enumerate(probe)])
    assert hits >= 0.95, f"self-retrieval@10 {hits:.3f}"


def test_energy_precision_at_10_vs_labels(built_5k):
    aspace, gl, data, labels, _ = built_5k
    rng = np.random.default_rng(5)
    probe = rng.integers(0, PER_5K * 5, 64)
    Q = data[probe] + rng.normal(0, 0.05, (64, F_5K)).astype(np.float32)
    idx, _ = em.search_energy_batch(aspace, Q.astype(np.float32), gl, K)
    idx = _np(idx)
    prec = np.mean([(labels[idx[r]] == labels[p]).mean() for r, p in enumerate(probe)])
    assert prec >= 0.8, f"energy precision@10 vs labels {prec:.3f}"


def test_energy_vs_standard_search_quality(built_5k, eigen_built_5k):
    aspace_e, gl_e, data, labels, _ = built_5k
    aspace_s, gl_s, _ = eigen_built_5k
    rng = np.random.default_rng(6)
    probe = rng.integers(0, PER_5K * 5, 48)
    Q = (data[probe] + rng.normal(0, 0.05, (48, F_5K))).astype(np.float32)
    e_idx = _np(em.search_energy_batch(aspace_e, Q, gl_e, K)[0])
    s_idx = _np(aspace_s.search_batch(Q, gl_s, K)[0])
    p_energy = np.mean([(labels[e_idx[r]] == labels[p]).mean() for r, p in enumerate(probe)])
    p_eigen = np.mean([(labels[s_idx[r]] == labels[p]).mean() for r, p in enumerate(probe)])
    assert p_energy >= 0.85 * p_eigen, f"energy {p_energy:.3f} vs eigen {p_eigen:.3f}"


def test_energy_lambda_distribution_structured(built_5k):
    aspace, _gl, _data, labels, _ = built_5k
    lam = _np(aspace.lambdas).astype(np.float64)
    sc = _np(aspace.subcentroid_lambdas).astype(np.float64)
    assert (np.abs(lam[:, None] - sc[None, :]).min(axis=1) < 1e-6).all()
    assert lam.max() - lam.min() > 0.1
    spreads = [lam[labels == c].std() for c in range(5)]
    assert np.mean(spreads) < (lam.max() - lam.min()), "degenerate spread"


def test_energy_ranking_is_pure_lambda_distance_at_scale(built_5k):
    """Given the prepared query λ, the returned distances are exactly the
    k smallest |λ_item − λ_q| over the corpus."""
    aspace, gl, data, _labels, _ = built_5k
    rng = np.random.default_rng(8)
    Q = data[rng.integers(0, N_5K, 32)]
    idx, dist = em.search_energy_batch(aspace, Q, gl, K)
    dist = _np(dist)
    lam = _np(aspace.lambdas).astype(np.float64)
    sc = _np(aspace.subcentroid_lambdas).astype(np.float32)
    subc = _np(aspace.sub_centroids)
    q_lams = np.asarray([sc[np.argmin(((subc - q) ** 2).sum(1))] for q in Q])
    for r in range(len(Q)):
        want = np.sort(np.abs(lam - q_lams[r]))[:K]
        np.testing.assert_allclose(np.sort(dist[r]), want, atol=1e-6)


def test_energy_build_time_same_magnitude_as_eigen(built_5k, eigen_built_5k):
    """The energy pipeline's extra stages stay within an order of
    magnitude of the eigen build (a floor of 1 s on the eigen side)."""
    *_, energy_build_s = built_5k
    *_, eigen_build_s = eigen_built_5k
    assert energy_build_s < 10 * max(eigen_build_s, 1.0), (
        f"energy {energy_build_s:.1f}s vs eigen {eigen_build_s:.1f}s"
    )


def test_energy_banded_matches_full_scan_at_scale(built_5k):
    aspace, gl, data, _labels, _ = built_5k
    rng = np.random.default_rng(9)
    Q = data[rng.integers(0, N_5K, 32)]
    full_idx = _np(em.search_energy_batch(aspace, Q, gl, K)[0])
    cand = aspace.max_lambda_tie_group() + K
    band_idx = _np(em.search_energy_batch(aspace, Q, gl, K, candidates=cand)[0])
    overlap = np.mean([
        len(set(full_idx[r].tolist()) & set(band_idx[r].tolist())) / K for r in range(len(Q))
    ])
    assert overlap == 1.0, f"banded overlap {overlap:.3f}"
