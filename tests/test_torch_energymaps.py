"""Port vs reference: the energy pipeline (``energymaps``) and energy-mode
``ArrowSpace``, on torch-CPU and JAX-CPU with the same numpy inputs.

Fixtures: ``make_energy_test_dataset(1200, 128, seed=7)`` built with a JL
projection (128 → 64, 16 optical tokens) by each package, at the cluster
settings of ``tests/test_torch_streaming.py``'s energy store (5 clusters,
7 sub-centroids) and at 60 clusters (optical compression to 16, 20
sub-centroids); the reference's build carried into the port with
``convert`` (the same state in both); the reference's synthetic index of
controlled tie groups (8192 × 32, 256 sub-centroids).

Tolerances:
* ``EnergyParams`` presets and optical compression: equal;
* L₀ (dense): 1e-6 absolute;
* diffusion and dispersion: 1e-5·max(|v|, 1);
* split rows: the same count, values within 1e-5;
* the whole build: sub-centroids within 1e-5; sub-centroid λ raw
  (``λ·range + min``) within 1e-5·max(|λ|, 1), the taumode tests' bound
  (the closed form's sums cancel on these rows: both packages stray from
  the float64 value by ≈ 5e-7, inside its f32 rounding bound), so the
  normalised λ within that over the range; λ stats within 1e-5;
  ``centroid_map`` equal except where the two nearest sub-centroids lie
  within 8·eps·(‖x‖² + ‖c‖²) of each other (the expanded form's rounding);
  ``item_norms`` within 1e-6 relative;
* searches on the carried index: the query λ equal; ids and distances
  under the same-k rule (``utils/parity.same_k_mismatches``) at 1e-14,
  the tie-break term ``1e-9·(1 − cos)`` at a cosine tolerance of 1e-5:
  |Δλ| is the same f32 difference in both, so two ids may trade places
  only inside an equal-λ group whose cosines agree within 1e-5 (the dots
  are summed in other orders);
  ``search_batch`` tiers under the same-k rule at 1e-5
  (``utils/parity.same_k_mismatches``, the cosine scale of the blend);
* searches across the two builds: ids equal, distances within twice the
  normalised λ bound above.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu import energymaps as jem
from matternet_rs_tpu.builder import ArrowSpaceBuilder as JBuilder
from matternet_rs_tpu.core import ArrowSpace as JArrowSpace
from matternet_rs_tpu.utils.fixtures import make_energy_test_dataset

from matternet_rs_tpu_torch import convert
from matternet_rs_tpu_torch import energymaps as tem
from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder as TBuilder
from matternet_rs_tpu_torch.core import QUANT_TIERS
from matternet_rs_tpu_torch.graph import GraphLaplacian as TGraphLaplacian
from matternet_rs_tpu_torch.graph import GraphParams as TGraphParams
from matternet_rs_tpu_torch.utils.parity import ENERGY_TIE_TOL, same_k_mismatches

CPU = "cpu"
K = 10
TOL_L0 = 1e-6
TOL_REL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)
PARAMS = dict(optical_tokens=16, neighbor_k=5, candidate_m=8)


def _builder(cls, clusters=(60, 4.0), **kw):
    return (cls(**kw).with_lambda_graph(1.0, 5).with_sparsity_check(False)
            .with_cluster_params(max_clusters=clusters[0], radius=clusters[1])
            .with_dims_reduction(True).with_seed(9))


def _carry(ja, jg):
    """The reference's energy index as the port's, on the CPU."""
    p = ja.projection
    return convert.arrowspace_from_arrays(
        np.asarray(ja.data), np.asarray(ja.lambdas), np.asarray(jg.matrix),
        min_lambdas=ja.min_lambdas, max_lambdas=ja.max_lambdas, range_lambdas=ja.range_lambdas,
        graph_params=dataclasses.asdict(jg.graph_params),
        tau_mode=(ja.taumode.mode, ja.taumode.param), init_data=np.asarray(jg.init_data),
        nnodes=jg.nnodes,
        projection=None if p is None else (p.original_dim, p.reduced_dim, p.seed),
        sub_centroids=np.asarray(ja.sub_centroids),
        subcentroid_lambdas=np.asarray(ja.subcentroid_lambdas),
        centroid_map=np.asarray(ja.centroid_map), item_norms=np.asarray(ja.item_norms),
        device=CPU,
    )


@pytest.fixture(scope="module", params=[(40, 120.0), (60, 4.0)], ids=["5-clusters", "60-clusters"])
def built(request):
    data = make_energy_test_dataset(1200, 128, seed=7).astype(np.float32)
    ja, jg = _builder(JBuilder, request.param).build_energy(data, jem.EnergyParams(**PARAMS))
    tb = _builder(TBuilder, request.param, device=CPU)
    ta, tg = tb.build_energy(data, tem.EnergyParams(**PARAMS))
    ca, cg = _carry(ja, jg)
    return data, (ja, jg), (ta, tg, tb), (ca, cg)


def _same(ref_i, ref_d, got_i, got_d):
    assert np.asarray(got_i).shape == np.asarray(ref_i).shape
    bad = same_k_mismatches(np.asarray(ref_i), np.asarray(ref_d), np.asarray(got_i),
                            np.asarray(got_d), ENERGY_TIE_TOL)
    assert not bad, bad[:3]


def _same_lists(ref, got):
    _same([[i for i, _ in ref]], [[s for _, s in ref]], [[i for i, _ in got]], [[s for _, s in got]])


def _queries(data, n, seed):
    rng = np.random.default_rng(seed)
    return (data[rng.integers(0, len(data), n)]
            + rng.normal(0, 0.05, (n, data.shape[1]))).astype(np.float32)


# ------------------------------------------------------------- parameters


def test_energy_params_presets_match():
    for n in (0, 10, 2500, 1_000_000, 5_000_000):
        assert tem.EnergyParams.compute_adaptive_tokens(n) == jem.EnergyParams.compute_adaptive_tokens(n)
    for k, dims, n in ((3, False, None), (6, True, None), (12, True, 40_000), (30, False, 900)):
        jb = JBuilder().with_lambda_graph(1.0, k).with_dims_reduction(dims, rp_eps=0.25)
        tb = TBuilder(device=CPU).with_lambda_graph(1.0, k).with_dims_reduction(dims, rp_eps=0.25)
        if n is not None:
            jb, tb = jb.with_expected_items(n), tb.with_expected_items(n)
        for preset in ("from_builder", "high_resolution", "large_dataset"):
            got = dataclasses.asdict(getattr(tem.EnergyParams, preset)(tb))
            ref = dataclasses.asdict(getattr(jem.EnergyParams, preset)(jb))
            assert got == ref, (preset, k, dims, n)
    assert dataclasses.asdict(tem.EnergyParams()) == dataclasses.asdict(jem.EnergyParams())


# ------------------------------------------------------- the build's steps


@pytest.mark.parametrize("x,f,budget,trim,seed", [
    (60, 16, 16, 0.1, 0), (200, 48, 50, 0.1, 3), (300, 32, 30, 0.25, 11), (40, 8, 100, 0.1, 1),
])
def test_optical_compression_matches(x, f, budget, trim, seed):
    c = np.random.default_rng(seed).normal(size=(x, f)).astype(np.float32)
    got = tem.optical_compress_centroids(c, budget, trim, seed=seed, device=CPU)
    ref = jem.optical_compress_centroids(c, budget, trim, seed=seed)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def _centroids(seed, x=40, f=24):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(x, f)) + rng.normal(size=(1, f)) * 3).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 5])
def test_bootstrap_laplacian_matches(seed):
    c = _centroids(seed)
    tb = TBuilder(device=CPU).with_lambda_graph(1.0, 5).with_sparsity_check(False)
    jb = JBuilder().with_lambda_graph(1.0, 5).with_sparsity_check(False)
    got, ref = tem.bootstrap_centroid_laplacian(c, tb), jem.bootstrap_centroid_laplacian(c, jb)
    assert got.energy and ref.energy and got.nnodes == ref.nnodes
    np.testing.assert_allclose(got.matrix.numpy(), np.asarray(ref.matrix), atol=TOL_L0, rtol=0)
    assert got.graph_params == TGraphParams(**dataclasses.asdict(ref.graph_params))


def _close(got, ref, tol=TOL_REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_array_less(np.abs(got - ref), tol * np.maximum(np.abs(ref), 1.0) + 1e-30)


@pytest.mark.parametrize("seed", [0, 5])
def test_diffusion_and_dispersion_match(seed):
    c = _centroids(seed)
    jb = JBuilder().with_lambda_graph(1.0, 5).with_sparsity_check(False)
    L = np.array(jem.bootstrap_centroid_laplacian(c, jb).matrix)
    for steps in (1, 4):
        got = tem._diffusion_kernel(torch.from_numpy(c), torch.from_numpy(L), 0.1, steps)
        ref = jem._diffusion_kernel(jnp.asarray(c), jnp.asarray(L), jnp.float32(0.1), jnp.zeros(steps))
        _close(got.numpy(), ref)
    gl_t = TGraphLaplacian(matrix=torch.from_numpy(L), init_data=torch.from_numpy(c.T.copy()),
                           nnodes=len(c), graph_params=TGraphParams())
    gl_j = jem.bootstrap_centroid_laplacian(c, jb)
    (lt, gt), (lj, gj) = tem.node_energy_and_dispersion(c, gl_t, 5), jem.node_energy_and_dispersion(c, gl_j, 5)
    _close(lt, lj)
    _close(gt, gj)
    assert np.all((gt >= 0) & (gt <= 1))


@pytest.mark.parametrize("seed,quantile", [(0, 0.9), (5, 0.75)])
def test_split_rows_match(seed, quantile):
    c = _centroids(seed)
    jb = JBuilder().with_lambda_graph(1.0, 5).with_sparsity_check(False)
    tb = TBuilder(device=CPU).with_lambda_graph(1.0, 5).with_sparsity_check(False)
    pj = jem.EnergyParams(neighbor_k=6, split_quantile=quantile)
    pt = tem.EnergyParams(neighbor_k=6, split_quantile=quantile)
    ref = jem.diffuse_and_split_subcentroids(c, jem.bootstrap_centroid_laplacian(c, jb), pj)
    got = tem.diffuse_and_split_subcentroids(c, tem.bootstrap_centroid_laplacian(c, tb), pt)
    assert got.shape == ref.shape and got.shape[0] > len(c)
    np.testing.assert_allclose(got, ref, atol=TOL_REL, rtol=0)


def test_split_needs_the_feature_graph():
    c = _centroids(0)
    tb = TBuilder(device=CPU).with_lambda_graph(1.0, 5).with_sparsity_check(False)
    l0 = tem.bootstrap_centroid_laplacian(c, tb)
    with pytest.raises(ValueError, match="must match feature count"):
        tem.diffuse_and_split_subcentroids(c[:, :10], l0, tem.EnergyParams())


# ------------------------------------------------------------- the build


def test_build_energy_matches_the_reference(built):
    data, (ja, jg), (ta, tg, tb), _ = built
    sc_j = np.asarray(ja.sub_centroids)
    assert tuple(ta.sub_centroids.shape) == sc_j.shape and sc_j.shape[1] == 64
    np.testing.assert_allclose(ta.sub_centroids.numpy(), sc_j, atol=TOL_REL, rtol=0)
    raw_t = ta.min_lambdas + ta.subcentroid_lambdas * ta.range_lambdas
    raw_j = ja.min_lambdas + np.asarray(ja.subcentroid_lambdas) * ja.range_lambdas
    _close(raw_t, raw_j)
    lam_tol = TOL_REL * max(1.0, np.abs(raw_j).max()) / ja.range_lambdas
    np.testing.assert_allclose(ta.subcentroid_lambdas, ja.subcentroid_lambdas, atol=lam_tol, rtol=0)
    for s in ("min_lambdas", "max_lambdas", "range_lambdas"):
        assert getattr(ta, s) == pytest.approx(getattr(ja, s), abs=TOL_REL)
    # centroid_map: a differing item must sit at a near tie of its two
    # nearest sub-centroids in the (projected) space it was assigned in.
    cm_t, cm_j = ta.centroid_map, np.asarray(ja.centroid_map)
    assert cm_t.dtype == np.int64 and cm_t.shape == (len(data),)
    Xp = ta.projection.project(torch.from_numpy(data)).numpy().astype(np.float64)
    d2 = ((Xp[:, None, :] - sc_j[None].astype(np.float64)) ** 2).sum(-1)
    for i in np.nonzero(cm_t != cm_j)[0]:
        bound = 8 * EPS32 * (np.sum(Xp[i] ** 2) + np.sum(sc_j[[cm_t[i], cm_j[i]]] ** 2, axis=1).max())
        assert abs(d2[i, cm_t[i]] - d2[i, cm_j[i]]) <= bound, i
    np.testing.assert_allclose(ta.lambdas.numpy(),
                               ta.subcentroid_lambdas[cm_t].astype(np.float32), rtol=0, atol=0)
    np.testing.assert_allclose(ta.item_norms.numpy(), np.asarray(ja.item_norms), rtol=1e-6)
    assert ta.max_lambda_tie_group() == ja.max_lambda_tie_group()
    assert tg.energy and tuple(tg.matrix.shape) == tuple(jg.matrix.shape)
    np.testing.assert_allclose(tg.matrix.numpy(), np.asarray(jg.matrix), atol=TOL_L0, rtol=0)
    assert set(tb.last_stage_timings) == {
        "clustering", "optical_compression", "bootstrap_laplacian", "diffuse_split",
        "energy_laplacian", "subcentroid_lambdas", "assignment"}


def test_energy_searches_agree_across_the_two_builds(built):
    data, (ja, jg), (ta, tg, _), _ = built
    Q = _queries(data, 8, 1)
    ri, rd = jem.search_energy_batch(ja, Q, jg, K)
    gi, gd = tem.search_energy_batch(ta, Q, tg, K)
    assert np.array_equal(gi, np.asarray(ri))
    lam_tol = 2 * TOL_REL * max(1.0, abs(ja.min_lambdas) + ja.range_lambdas) / ja.range_lambdas
    np.testing.assert_allclose(gd, np.asarray(rd), atol=lam_tol, rtol=0)


def test_build_energy_rejects_what_the_reference_rejects():
    data = make_energy_test_dataset(200, 16, seed=1).astype(np.float32)
    with pytest.raises(ValueError, match="dim reduction is needed"):
        TBuilder(device=CPU).build_energy(data)
    with pytest.raises(ValueError, match="Spectral mode"):
        TBuilder(device=CPU).with_dims_reduction(True).with_spectral(True).build_energy(data)
    with pytest.raises(ValueError, match="unknown pipeline"):
        TBuilder(device=CPU).build_for_persistence(data, pipeline="bogus")


def test_build_for_persistence_energy_writes_the_reference_files(tmp_path):
    data = make_energy_test_dataset(300, 32, seed=2).astype(np.float32)
    tb = _builder(TBuilder, device=CPU).with_persistence("en", tmp_path / "t")
    jb = _builder(JBuilder).with_persistence("en", tmp_path / "j")
    ta, _ = tb.build_for_persistence(data, pipeline="energy", energy_params=tem.EnergyParams(**PARAMS))
    ja, _ = jb.build_for_persistence(data, pipeline="energy", energy_params=jem.EnergyParams(**PARAMS))
    assert ta.sub_centroids is not None
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert "en-raw_input.parquet" in names and "en-gl-matrix.parquet" in names


# ------------------------------------------------- searches, carried index


def test_carried_index_holds_the_reference_state(built):
    _, (ja, jg), _, (ca, cg) = built
    assert cg.energy and ca.projection == ca.projection.__class__(128, 64, 9)
    assert np.array_equal(ca.centroid_map, np.asarray(ja.centroid_map))
    assert np.array_equal(ca.item_norms.numpy(), np.asarray(ja.item_norms))
    assert ca.max_lambda_tie_group() == ja.max_lambda_tie_group() > 100


def test_prepare_query_item_energy_mode(built):
    data, (ja, jg), _, (ca, cg) = built
    for q in list(_queries(data, 6, 2)) + [data[0] * 0.0 + 1e-3]:
        assert ca.prepare_query_item(q, cg) == ja.prepare_query_item(q, jg)
    # An original-width query is projected; a reduced-width one is not.
    qr = np.asarray(ja.projection.project(jnp.asarray(data[5])))
    assert ca.prepare_query_item(qr, cg) == ja.prepare_query_item(qr, jg)
    with pytest.raises(ValueError, match="sub-centroid dimension"):
        ca.prepare_query_item(data[0, :50], cg)
    with pytest.raises(ValueError, match="non-finite"):
        ca.prepare_query_item(np.full(128, np.nan, np.float32), cg)


def test_search_energy_matches(built):
    data, (ja, jg), _, (ca, cg) = built
    for q in _queries(data, 4, 3):
        _same_lists(jem.search_energy(ja, q, jg, K), tem.search_energy(ca, q, cg, K))
    assert len(tem.search_energy(ca, data[3], cg, 5000)) == 1200
    assert tem.search_energy(ca, data[3], cg, 3)[0][0] == 3


def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("b", [8, 256])
@pytest.mark.parametrize("candidates", [None, "auto", "window"])
def test_search_energy_batch_matches_and_routes_alike(built, monkeypatch, b, candidates):
    data, (ja, jg), _, (ca, cg) = built
    if candidates == "window":
        candidates = ca.max_lambda_tie_group() // 4      # banded, narrower than a tie group
    Q = _queries(data, b, 4 + b)
    jcalls = _spy(monkeypatch, jem, "_batched_energy_banded_jit")
    tcalls = _spy(monkeypatch, tem, "_banded_search")
    ri, rd = jem.search_energy_batch(ja, Q, jg, K, candidates=candidates)
    gi, gd = tem.search_energy_batch(ca, Q, cg, K, candidates=candidates)
    assert len(tcalls) == len(jcalls) == (1 if isinstance(candidates, int) else 0)
    assert gi.shape == (b, K)
    _same(ri, rd, gi, gd)


def test_search_energy_batch_refuses_an_eigen_index():
    data = make_energy_test_dataset(200, 16, seed=1).astype(np.float32)
    a, g = TBuilder(device=CPU).with_lambda_graph(1.0, 5).with_sparsity_check(False) \
        .with_cluster_params(max_clusters=10, radius=4.0).build(data)
    with pytest.raises(ValueError, match="not an energy-mode index"):
        tem.search_energy_batch(a, data[:2], g, 3)


def test_search_energy_adaptive_matches(built):
    data, (ja, jg), _, (ca, cg) = built
    assert tem.adaptive_energy_weights(ca) == jem.adaptive_energy_weights(ja)
    for q in _queries(data, 3, 5):
        got, ref = tem.search_energy_adaptive(ca, q, cg, K), jem.search_energy_adaptive(ja, q, jg, K)
        assert [i for i, _ in got] == [i for i, _ in ref]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], atol=1e-6, rtol=0)


@pytest.mark.parametrize("tier", [False, True] + sorted(QUANT_TIERS))
def test_energy_search_batch_every_tier(built, tier):
    data, (ja, jg), _, (ca, cg) = built
    Q = _queries(data, 8, 6)
    kw = {"allow_low_recall": True} if tier == "bf16_rescored" else {}
    ri, rs, rraw = ja.search_batch(Q, jg, K, quantized=tier, return_raw=True, **kw)
    gi, gs, graw = ca.search_batch(Q, cg, K, quantized=tier, return_raw=True, **kw)
    assert np.array_equal(graw, np.asarray(rraw))
    assert not same_k_mismatches(np.asarray(ri), np.asarray(rs), gi, gs, 1e-5)


# ------------------------------------------------------ controlled ties


def _synthetic(n=4096, f=32, n_sub=64, seed=0):
    """The reference's synthetic energy index (tests/test_energymaps.py)
    in both packages: sorted sub-centroid λ, random assignment."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, f)).astype(np.float32)
    sub_c = rng.normal(size=(n_sub, f)).astype(np.float32)
    sc_lams = np.sort(rng.uniform(0.0, 1.0, n_sub)).astype(np.float32)
    assign = rng.integers(0, n_sub, n)
    ja = JArrowSpace.from_items(data)
    ja.sub_centroids = jnp.asarray(sub_c)
    ja.subcentroid_lambdas = jnp.asarray(sc_lams)
    ja.lambdas = jnp.asarray(sc_lams[assign])
    ja.item_norms = jnp.sqrt(jnp.sum(ja.data * ja.data, axis=1))
    ja.min_lambdas, ja.max_lambdas, ja.range_lambdas = 0.0, 1.0, 1.0
    ta, _ = convert.arrowspace_from_arrays(
        data, sc_lams[assign], np.eye(f, dtype=np.float32), min_lambdas=0.0, max_lambdas=1.0,
        range_lambdas=1.0, sub_centroids=sub_c, subcentroid_lambdas=sc_lams,
        centroid_map=assign, device=CPU)
    return ja, ta, data


def test_energy_banded_matches_full_scan_controlled_ties():
    ja, ta, data = _synthetic()
    rng = np.random.default_rng(3)
    Q = (data[rng.integers(0, len(data), 16)] + rng.normal(0, 0.05, (16, data.shape[1]))).astype(np.float32)
    cand = ta.max_lambda_tie_group() + 10
    assert cand == ja.max_lambda_tie_group() + 10 and 2 * cand <= ta.nitems
    full_i, full_d = tem.search_energy_batch(ta, Q, None, 10)
    band_i, band_d = tem.search_energy_batch(ta, Q, None, 10, candidates=cand)
    assert np.array_equal(band_i, full_i)
    np.testing.assert_allclose(band_d, full_d, rtol=1e-6, atol=1e-9)
    ref_i, ref_d = jem.search_energy_batch(ja, Q, None, 10, candidates=cand)
    assert np.array_equal(band_i, np.asarray(ref_i))
    np.testing.assert_allclose(band_d, np.asarray(ref_d), rtol=1e-6, atol=1e-9)


def test_energy_banded_auto_engages_on_a_spread_corpus(monkeypatch):
    ja, ta, data = _synthetic(n=8192, n_sub=256, seed=4)
    tcalls = _spy(monkeypatch, tem, "_banded_search")
    jcalls = _spy(monkeypatch, jem, "_batched_energy_banded_jit")
    for b in (2, 8):                     # 2·cand·b_pad ≤ N/10 bands at 2, not at 8
        got = tem.search_energy_batch(ta, data[:b], None, 10, candidates="auto")
        ref = jem.search_energy_batch(ja, data[:b], None, 10, candidates="auto")
        assert len(tcalls) == len(jcalls) == 1
        _same(ref[0], ref[1], got[0], got[1])
        full = tem.search_energy_batch(ta, data[:b], None, 10)
        assert np.array_equal(got[0], full[0])


def test_max_lambda_tie_group_is_cached_per_lambda_tensor(built):
    _, _, _, (ca, _) = built
    first = ca.max_lambda_tie_group()
    lam = ca.lambdas
    ca.lambdas = torch.arange(ca.nitems, dtype=torch.float32)
    try:
        assert ca.max_lambda_tie_group() == 1
    finally:
        ca.lambdas = lam
    assert ca.max_lambda_tie_group() == first


def test_argmin_and_argmax_take_the_first_index_on_ties():
    """The assignment and the query λ rely on ``lax``'s first-index rule."""
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0], [0.5, 0.5, 0.5, 0.5]])
    assert torch.argmin(x, dim=1).tolist() == [1, 0]
    assert torch.argmax(-x, dim=1).tolist() == [1, 0]
    big = torch.zeros(3, 70_000)
    big[:, 5] = big[:, 40_000] = -1.0
    assert torch.argmin(big, dim=1).tolist() == [5, 5, 5]
