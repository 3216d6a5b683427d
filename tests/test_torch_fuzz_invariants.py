"""Seeded config-space fuzzing of the port: the random (dataset, builder
configuration) pairs of ``tests/test_fuzz_invariants.py``, with its seeds
and invariants, built and searched on the CPU (``device="cpu"``): λ in
[0, 1] and finite, a valid Laplacian, self-retrieval, batched equal to
serial, a sorted λ index; checkpoints round-tripped; energy builds;
distributed builds on the port's 8-slot CPU mesh equal to the serial scan;
the banded energy search equal to the full scan. Each random build is also
held to the reference's build of the same input: the same Laplacian
(within 1e-6), the same λ (within 2e-5, the reference's f32 tolerance
against its float64 oracle) and the same self-query ids, except where the
spectral Laplacian's edges follow rounding noise (ROADMAP Queue 3). The
adversarial tie corpora are in
``tests/test_torch_fuzz_tie_corpora.py``."""

import numpy as np
import pytest
import torch

from matternet_rs_tpu.builder import ArrowSpaceBuilder as JBuilder
from matternet_rs_tpu.core import TauMode as JTauMode

from matternet_rs_tpu_torch import energymaps as em
from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder
from matternet_rs_tpu_torch.core import ArrowSpace, TauMode, UndecidableQueryError
from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.ops import search as search_ops
from matternet_rs_tpu_torch.ops import taumode as tm_ops
from matternet_rs_tpu_torch.parallel import make_mesh
from matternet_rs_tpu_torch.parallel.index import ShardedArrowSpace

CPU = "cpu"
LAMBDA_TOL = 2e-5


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mesh():
    return make_mesh(8, devices=[CPU] * 8)


def _random_config(rng, builder=ArrowSpaceBuilder, taumodes=TauMode, **kw):
    """The reference's ``_random_config``: the same draws in the same
    order, applied to ``builder`` (the port's, or the reference's)."""
    n = int(rng.integers(60, 400))
    f = int(rng.integers(8, 96))
    n_centers = int(rng.integers(2, 8))
    centers = rng.normal(size=(n_centers, f)) * rng.uniform(2.0, 10.0)
    data = (
        centers[rng.integers(0, n_centers, n)] + rng.normal(size=(n, f))
    ).astype(np.float32)

    tau = rng.choice(["median", "mean", "fixed", "percentile"])
    taumode = {
        "median": lambda: taumodes.median(),
        "mean": lambda: taumodes.mean(),
        "fixed": lambda: taumodes.fixed(float(rng.uniform(0.05, 0.95))),
        "percentile": lambda: taumodes.percentile(float(rng.uniform(0.1, 0.9))),
    }[tau]()

    b = (
        builder(**kw)
        .with_lambda_graph(
            eps=float(rng.uniform(0.5, 1.0)),
            k=int(rng.integers(3, 9)),
        )
        .with_synthesis(taumode)
        .with_sparsity_check(False)
        .with_normalisation(bool(rng.integers(0, 2)))
        .with_cluster_params(
            max_clusters=int(rng.integers(4, max(5, n // 8))),
            radius=float(rng.uniform(5.0, 60.0)),
        )
        .with_sampling(None)
        .with_seed(int(rng.integers(0, 1000)))
    )
    if rng.random() < 0.3:
        b.with_spectral(True)
    return data, b


@pytest.mark.parametrize("seed", range(15))
def test_random_config_invariants(seed):
    rng = np.random.default_rng(1000 + seed)
    data, b = _random_config(rng, device=CPU)
    jdata, jb = _random_config(np.random.default_rng(1000 + seed), JBuilder, JTauMode)
    assert np.array_equal(data, jdata)
    aspace, gl = b.build(data)
    ja, jgl = jb.build(data)

    lam = _np(aspace.lambdas)
    assert lam.shape == (len(data),)
    assert np.isfinite(lam).all()
    assert (lam >= 0).all() and (lam <= 1).all()
    assert aspace.range_lambdas > 0
    L = gl.dense()
    np.testing.assert_allclose(_np(L), np.asarray(jgl.dense()), atol=1e-6, rtol=0)
    # ROADMAP Queue 3: with the second-order (spectral) Laplacian and
    # ``normalise``, an isolated node's zero row of L standardises to the
    # rounding noise of column means that are 0 in exact arithmetic, and
    # its unit-scaled cosines (so its edges, so λ) follow that noise in
    # either package. Where that happens the mechanism is held instead.
    zero_rows = torch.sum(torch.abs(L), dim=1) == 0
    noise_driven = b.prebuilt_spectral and b.normalise and bool(zero_rows.any())
    if noise_driven:
        from matternet_rs_tpu_torch.ops.distance import standardize_columns

        assert float(torch.linalg.norm(standardize_columns(L)[zero_rows], dim=1).max()) < 1e-6
    else:
        np.testing.assert_allclose(lam, np.asarray(ja.lambdas), atol=LAMBDA_TOL, rtol=0)

    v = gl.verify_properties()
    assert v["symmetric"] and v["row_sums_zero"] and v["diag_nonneg"]

    qi = int(rng.integers(0, len(data)))
    try:
        ql = aspace.prepare_query_item(data[qi], gl)
    except UndecidableQueryError:
        # The reference's panic for raw λ ≈ 0, acceptable only when the
        # item's raw λ really is ~0 under this configuration.
        raw = float(tm_ops.synthetic_lambda(
            torch.from_numpy(data[qi]), aspace.graph_for_taumode(gl),
            aspace.taumode.mode, aspace.taumode.param,
        ))
        assert abs(raw) <= 1e-12, f"spurious undecidable: raw λ = {raw}"
        return
    res = aspace.search_lambda_aware(data[qi], ql, 5)
    assert res[0][0] == qi, f"seed {seed}: self-query lost, got {res[:3]}"
    if not noise_driven:
        jres = ja.search_lambda_aware(data[qi], ja.prepare_query_item(data[qi], jgl), 5)
        assert [i for i, _ in res] == [i for i, _ in jres]
    scores = [s for _, s in res]
    assert scores == sorted(scores, reverse=True)

    idx, _ = aspace.search_batch(data[qi][None, :], gl, 5)
    assert idx[0].tolist() == [i for i, _ in res]

    aspace.build_lambdas_sorted()
    s_lam = np.asarray(aspace.lambdas_sorted.sorted_lambdas)
    assert (np.diff(s_lam) >= -1e-7).all()


@pytest.mark.parametrize("seed", range(6))
def test_random_config_checkpoint_roundtrip(seed, tmp_path):
    from matternet_rs_tpu_torch.storage import parquet as pq

    rng = np.random.default_rng(2000 + seed)
    data, b = _random_config(rng, device=CPU)
    aspace, gl = b.build(data)
    pq.save_checkpoint(aspace, gl, b, tmp_path, f"fuzz{seed}")
    a2, g2 = pq.load_arrowspace(tmp_path, f"fuzz{seed}", device=CPU)
    qi = int(rng.integers(0, len(data)))
    ql1 = aspace.prepare_query_item(data[qi], gl)
    ql2 = a2.prepare_query_item(data[qi], g2)
    assert ql1 == pytest.approx(ql2, abs=1e-6)
    assert aspace.search_lambda_aware(data[qi], ql1, 5) == a2.search_lambda_aware(
        data[qi], ql2, 5
    )


@pytest.mark.parametrize("seed", range(7))
def test_random_energy_config_invariants(seed):
    rng = np.random.default_rng(3000 + seed)
    n = int(rng.integers(100, 300))
    f = int(rng.integers(16, 64))
    n_centers = int(rng.integers(2, 6))
    centers = rng.normal(size=(n_centers, f)) * rng.uniform(3.0, 8.0)
    data = (
        centers[rng.integers(0, n_centers, n)] + rng.normal(size=(n, f))
    ).astype(np.float32)
    b = (
        ArrowSpaceBuilder(device=CPU)
        .with_lambda_graph(float(rng.uniform(0.6, 1.0)), int(rng.integers(3, 7)))
        .with_sparsity_check(False)
        .with_cluster_params(
            max_clusters=int(rng.integers(6, 24)),
            radius=float(rng.uniform(8.0, 40.0)),
        )
        .with_dims_reduction(True)
        .with_sampling(None)
        .with_seed(int(rng.integers(0, 1000)))
    )
    p = em.EnergyParams(
        optical_tokens=int(rng.integers(8, 30)),
        steps=int(rng.integers(1, 6)),
        neighbor_k=int(rng.integers(3, 10)),
        split_quantile=float(rng.uniform(0.7, 0.95)),
        candidate_m=int(rng.integers(6, 20)),
    )
    aspace, gl = b.build_energy(data, p)

    lam = _np(aspace.lambdas)
    assert (lam >= 0).all() and (lam <= 1).all() and np.isfinite(lam).all()
    cm = np.asarray(aspace.centroid_map)
    S = aspace.sub_centroids.shape[0]
    assert cm.min() >= 0 and cm.max() < S
    assert aspace.range_lambdas > 0

    qi = int(rng.integers(0, n))
    res = em.search_energy(aspace, data[qi], gl, k=5)
    dists = [d for _, d in res]
    assert dists == sorted(dists)
    assert all(d >= -1e-9 for d in dists)
    idx, _ = em.search_energy_batch(aspace, data[qi][None, :], gl, 5)
    assert _np(idx)[0].tolist() == [i for i, _ in res]


@pytest.mark.parametrize("seed", range(4))
def test_random_distributed_matches_serial(seed):
    """Distributed build and search on 8 CPU slots equal the serial scan
    of the concatenated data."""
    rng = np.random.default_rng(4000 + seed)
    n = int(rng.integers(120, 500))
    f = int(rng.integers(8, 48))
    data = rng.normal(size=(n, f)).astype(np.float32) * rng.uniform(0.5, 4.0)
    params = GraphParams(
        eps=float(rng.uniform(0.6, 1.0)), k=int(rng.integers(3, 8)),
        topk=int(rng.integers(3, 8)), sparsity_check=False,
    )
    cut = int(rng.integers(1, n - 1))
    sa = ShardedArrowSpace.distributed_build(
        [data[:cut], data[cut:]], params, k_clusters=int(rng.integers(4, 16)), mesh=_mesh(),
    )
    k = int(rng.integers(3, 12))
    qi = int(rng.integers(0, n))
    ql = sa.prepare_query_lambda(data[qi])
    dist_res = sa.search(data[qi], k=k)
    X = torch.from_numpy(data)
    ser_idx, _ = search_ops.search_lambda_aware(
        X, torch.sqrt(torch.sum(X * X, dim=-1)), sa.lambdas.gather()[:n],
        X[qi], torch.tensor(ql, dtype=torch.float32), k,
    )
    assert [i for i, _ in dist_res] == ser_idx.tolist(), f"seed {seed}: distributed != serial"


@pytest.mark.parametrize("seed", range(3))
def test_random_distributed_energy_matches_serial(seed):
    """Distributed energy search (λ distance ascending, cosine tie-break)
    equals a serial scan with the same score."""
    rng = np.random.default_rng(5000 + seed)
    n = int(rng.integers(100, 400))
    f = int(rng.integers(8, 32))
    data = rng.normal(size=(n, f)).astype(np.float32)
    params = GraphParams(
        eps=float(rng.uniform(0.7, 1.0)), k=int(rng.integers(3, 7)),
        topk=int(rng.integers(3, 7)), sparsity_check=False,
    )
    sa = ShardedArrowSpace.distributed_build(
        [data], params, k_clusters=int(rng.integers(4, 12)), mesh=_mesh()
    )
    k = int(rng.integers(3, 10))
    qi = int(rng.integers(0, n))
    ql = sa.prepare_query_lambda(data[qi])
    dist_res = sa.search_energy(data[qi], k=k)

    lam = _np(sa.lambdas.gather())[:n].astype(np.float64)
    lam_dist = np.abs(ql - lam)
    norms = np.linalg.norm(data, axis=1)
    cos = (data @ data[qi]) / (np.linalg.norm(data[qi]) * norms + 1e-9)
    scores = lam_dist + np.where(lam_dist < 1e-9, (1.0 - cos) * 1e-9, 0.0)
    order = np.lexsort((np.arange(n), scores.astype(np.float32)))[:k]
    assert [i for i, _ in dist_res] == order.tolist(), f"seed {seed}"


@pytest.mark.parametrize("seed", [2, 9, 31])
def test_random_banded_energy_matches_full_scan(seed):
    """The banded energy search's distances equal the full scan's wherever
    the window covers the tie groups; indices agree away from exact
    score ties."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2000, 6000))
    f = int(rng.choice([8, 32, 96]))
    s = int(rng.integers(16, 200))
    data = rng.normal(size=(n, f)).astype(np.float32)
    aspace = ArrowSpace.from_items(data, device=CPU)
    aspace.sub_centroids = torch.from_numpy(rng.normal(size=(s, f)).astype(np.float32))
    sc_l = np.sort(rng.uniform(0, 1, s)).astype(np.float32)
    assign = rng.integers(0, s, n)
    aspace.subcentroid_lambdas = sc_l
    aspace.lambdas = torch.from_numpy(sc_l[assign])
    aspace.item_norms = torch.sqrt(torch.sum(aspace.data * aspace.data, dim=1))

    Q = data[rng.integers(0, n, 8)]
    ref_idx, ref_d = (_np(a) for a in em.search_energy_batch(aspace, Q, None, 10))
    got_idx, got_d = (_np(a) for a in em.search_energy_batch(aspace, Q, None, 10,
                                                             candidates="auto"))
    np.testing.assert_allclose(got_d, ref_d, rtol=1e-6, atol=1e-10)
    ties = np.isclose(ref_d[:, :-1], ref_d[:, 1:], rtol=0, atol=1e-12)
    for b in range(ref_d.shape[0]):
        if not ties[b].any():
            np.testing.assert_array_equal(got_idx[b], ref_idx[b])
