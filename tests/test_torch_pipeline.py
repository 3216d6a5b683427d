"""Port vs reference: the staged pipeline A → B0 → B1 → B2 → C → D
(``pipeline/``) and what it imports (the rest of ``ops/distance.py``,
``ops/taumode.rayleigh_quotient``/``item_dispersion``,
``graph.GraphFactory``, the rest of ``backend.py``, the fixture
``make_gaussian_hd``), on JAX-CPU and torch-CPU with the same numpy
inputs; the whole chain also against the float64 staged oracle
(``oracle_staged.run_staged``).

Tolerances (float32 in both, sums in other orders):
* stage A: equal (one C++ scan; the Python scan makes the same decisions);
* B0: equal means and variances, stats within 1e-6 relative;
* B1: equal candidate edges, tree, order and trunk; weights within 1e-5
  relative;
* B2: filtered and smoothed state within 1e-5 absolute, gains within 1e-6;
* C: equal topology, values within 1e-5 absolute;
* D: λ within 1e-5·max(|λ|, 1); τ equal to the reference's τ of the same
  λ, and within the λ bound of the reference's own τ;
* distances: within 1e-5 relative; the tiled Bhattacharyya pass equal at
  two block sizes;
* against the oracle: the reference's own bounds (its
  ``test_staged_pipeline_parity``) for each stage, and λ within
  1e-5·max(|λ|, 1), for the chain and for stage D on the port's L.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu import backend as jbackend
from matternet_rs_tpu import graph as jgraph
from matternet_rs_tpu import native as jnative
from matternet_rs_tpu import oracle_staged as osg
from matternet_rs_tpu import pipeline as jp
from matternet_rs_tpu.ops import distance as jdist
from matternet_rs_tpu.ops import taumode as jtau
from matternet_rs_tpu.pipeline import mst as jmst
from matternet_rs_tpu.pipeline import run as jrun
from matternet_rs_tpu.pipeline import smoothing as jsm
from matternet_rs_tpu.pipeline import spectral as jspec
from matternet_rs_tpu.utils import fixtures as jfix

from matternet_rs_tpu_torch import backend as tbackend
from matternet_rs_tpu_torch import graph as tgraph
from matternet_rs_tpu_torch import native as tnative
from matternet_rs_tpu_torch import pipeline as tp
from matternet_rs_tpu_torch.ops import distance as tdist
from matternet_rs_tpu_torch.ops import taumode as ttau
from matternet_rs_tpu_torch.pipeline import mst as tmst
from matternet_rs_tpu_torch.pipeline import run as trun
from matternet_rs_tpu_torch.pipeline import smoothing as tsm
from matternet_rs_tpu_torch.pipeline import spectral as tspec
from matternet_rs_tpu_torch.utils import fixtures as tfix

CPU = "cpu"
TOL = 1e-5


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_rel(ref, got, tol=TOL):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert np.all(np.abs(ref - got) <= tol * np.maximum(1.0, np.abs(ref))), \
        float(np.max(np.abs(ref - got) / np.maximum(1.0, np.abs(ref))))


def _states(means, variances, counts=None):
    counts = np.ones(len(means), np.int32) if counts is None else counts
    js = jp.CentroidState(means=jnp.asarray(means), variances=jnp.asarray(variances),
                          counts=jnp.asarray(counts, jnp.int32))
    ts = tp.CentroidState(means=torch.from_numpy(np.array(means, np.float32)),
                          variances=torch.from_numpy(np.array(variances, np.float32)),
                          counts=torch.from_numpy(np.array(counts, np.int32)))
    return js, ts


@pytest.fixture(scope="module")
def state():
    """The reference's stage-B fixture (``tests/test_pipeline.py``)."""
    rng = np.random.default_rng(0)
    means = rng.normal(size=(12, 6)).astype(np.float32)
    variances = rng.uniform(0.05, 0.5, size=(12, 6)).astype(np.float32)
    return _states(means, variances, rng.integers(1, 20, 12))


@pytest.fixture(scope="module")
def blob_state():
    """Stage A of ``make_gaussian_blob(300, 0.4)`` in the reference, then B0."""
    X = jfix.make_gaussian_blob(300, 0.4).astype(np.float32)
    a = jp.ClusteringStage(jp.ClusteringConfig(max_clusters=40, radius_threshold=4.0)).execute(X)
    b0 = jp.PreflightStage().execute(a.state)
    return X, _states(np.asarray(b0.normalized_centroids), np.asarray(b0.variances),
                      np.asarray(a.state.counts))


# ------------------------------------------------------------ the pieces


def test_make_gaussian_hd_is_the_reference_fixture():
    for n, noise in ((300, 0.3), (1000, 0.5), (7, 0.3)):
        got, ref = tfix.make_gaussian_hd(n, noise), jfix.make_gaussian_hd(n, noise)
        assert got.dtype == ref.dtype and got.shape == ref.shape == (n, 100)
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_distances_match_reference(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(23, 9)).astype(np.float32)
    b = rng.normal(size=(17, 9)).astype(np.float32)
    va = rng.uniform(1e-8, 2.0, (23, 9)).astype(np.float32)
    vb = rng.uniform(1e-8, 2.0, (17, 9)).astype(np.float32)
    ta, tb, tva, tvb = (torch.from_numpy(x) for x in (a, b, va, vb))
    ja, jb, jva, jvb = (jnp.asarray(x) for x in (a, b, va, vb))
    pairs = [
        (tdist.pairwise_sqeuclidean(ta, tb), jdist.pairwise_sqeuclidean(ja, jb)),
        (tdist.pairwise_sqeuclidean(ta), jdist.pairwise_sqeuclidean(ja)),
        (tdist.pairwise_euclidean(ta, tb), jdist.pairwise_euclidean(ja, jb)),
        (tdist.bhattacharyya_pairwise(ta, tva, tb, tvb), jdist.bhattacharyya_pairwise(ja, jva, jb, jvb)),
        (tdist.bhattacharyya_pairwise(ta, tva, var_floor=1e-3),
         jdist.bhattacharyya_pairwise(ja, jva, var_floor=1e-3)),
        (tdist.bhattacharyya_diagonal(ta[0], tva[0], tb[1], tvb[1]),
         jdist.bhattacharyya_diagonal(ja[0], jva[0], jb[1], jvb[1])),
        (tdist.bhattacharyya_affinity(ta[2], tva[2], tb[3], tvb[3]),
         jdist.bhattacharyya_affinity(ja[2], jva[2], jb[3], jvb[3])),
        (tdist.bhattacharyya_coefficient(torch.tensor([0.0, 0.5, 3.0])),
         jdist.bhattacharyya_coefficient(jnp.asarray([0.0, 0.5, 3.0]))),
        (tdist.cosine_similarity(ta[0], tb[0]), jdist.cosine_similarity(ja[0], jb[0])),
        (tdist.cosine_similarity(ta[0], torch.zeros(9)), jdist.cosine_similarity(ja[0], jnp.zeros(9))),
    ]
    for got, ref in pairs:
        assert got.shape == np.asarray(ref).shape
        _close_rel(np.asarray(ref), got.numpy())
    assert tdist.VAR_FLOOR == jdist.VAR_FLOOR


@pytest.mark.parametrize("block_elems", [1, 9 * 17, 3 * 17 * 9, 1 << 26])
def test_bhattacharyya_pairwise_is_equal_at_any_block_size(block_elems):
    """One row a block, then 1, 3 and all 23 rows: every entry bit-equal."""
    rng = np.random.default_rng(3)
    mu = torch.from_numpy(rng.normal(size=(23, 9)).astype(np.float32))
    var = torch.from_numpy(rng.uniform(0.01, 1.0, (23, 9)).astype(np.float32))
    mu_b = torch.from_numpy(rng.normal(size=(17, 9)).astype(np.float32))
    var_b = torch.from_numpy(rng.uniform(0.01, 1.0, (17, 9)).astype(np.float32))
    whole = tdist.bhattacharyya_pairwise(mu, var, mu_b, var_b, block_elems=1 << 30)
    got = tdist.bhattacharyya_pairwise(mu, var, mu_b, var_b, block_elems=block_elems)
    assert torch.equal(got, whole)


@pytest.mark.parametrize("f", [1, 2, 3, 7, 8, 100, 129])
def test_tree_sum_matches_a_float64_sum(f):
    x = torch.from_numpy(np.random.default_rng(f).normal(size=(5, f)).astype(np.float32))
    ref = x.double().sum(-1)
    assert torch.allclose(tdist.tree_sum_last(x).double(), ref, atol=1e-5, rtol=0)


def test_taumode_single_vector_helpers_match_reference():
    rng = np.random.default_rng(4)
    A = rng.uniform(0, 1, (8, 8)).astype(np.float32)
    A = (A + A.T) / 2
    np.fill_diagonal(A, 0)
    L = (np.diag(A.sum(1)) - A).astype(np.float32)
    for x in (rng.normal(size=8).astype(np.float32), np.zeros(8, np.float32),
              np.ones(8, np.float32)):
        _close_rel(np.asarray(jtau.rayleigh_quotient(jnp.asarray(L), jnp.asarray(x))),
                   ttau.rayleigh_quotient(torch.from_numpy(L), torch.from_numpy(x)).numpy())
        _close_rel(np.asarray(jtau.item_dispersion(jnp.asarray(x), jnp.asarray(L))),
                   ttau.item_dispersion(torch.from_numpy(x), torch.from_numpy(L)).numpy())


def test_graph_factory_matches_reference():
    C = jfix.make_gaussian_blob(60, 0.4).astype(np.float32)[:12]
    kw = dict(eps=1.0, k=5, topk=3, p=2.0, sigma_override=None, normalise=False,
              sparsity_check=False, n_items=60)
    ref = jgraph.GraphFactory.build_laplacian_matrix_from_k_cluster(C, **kw)
    got = tgraph.GraphFactory.build_laplacian_matrix_from_k_cluster(C, **kw)
    np.testing.assert_allclose(got.matrix.numpy(), np.asarray(ref.matrix), atol=1e-6, rtol=0)
    assert got.graph_params.topk == 3 and got.nnodes == ref.nnodes


def test_backend_rest():
    assert tbackend.is_tpu_available() is False
    assert tbackend.get_device("cpu") == torch.device("cpu")
    assert tbackend.dispatch(lambda: torch.zeros(2).device, "cpu") == torch.device("cpu")
    with tbackend.on_device("cpu"):
        assert torch.ones(1).device == torch.device("cpu")
    with pytest.raises(ValueError, match="no device matching"):
        tbackend.get_device("tpu")
    tbackend.print_backend_info()
    jbackend.print_backend_info()
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no device matching"):
            tbackend.get_device("gpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbackend.get_device()


def test_config_presets_match_reference():
    for name in ("ClusteringConfig", "PreflightConfig", "MSTConfig", "SmoothingConfig",
                 "LaplacianConfig", "PipelineConfig", "TauMode"):
        assert dataclasses.asdict(getattr(tp, name)()) == dataclasses.asdict(getattr(jp, name)()), name
    for cls, presets in (("ClusteringConfig", ("high_dimensional",)),
                         ("PreflightConfig", ("conservative", "strict")),
                         ("MSTConfig", ("high_dimensional", "prototype")),
                         ("SmoothingConfig", ("conservative", "aggressive"))):
        for p in presets:
            assert (dataclasses.asdict(getattr(getattr(tp, cls), p)())
                    == dataclasses.asdict(getattr(getattr(jp, cls), p)())), (cls, p)
    assert dataclasses.asdict(tsm.SmoothingConfig.trunk_aware(0.3)) == \
        dataclasses.asdict(jsm.SmoothingConfig.trunk_aware(0.3))
    for n, f, eps in ((10, 500, 0.3), (10_000, 2000, 0.3), (1, 40, 0.5), (200_000, 100, 0.3)):
        assert tp.clustering.compute_jl_dimension(n, f, eps) == \
            jp.clustering.compute_jl_dimension(n, f, eps)


@pytest.mark.parametrize("mode", [("median", 0.0), ("mean", 0.0), ("fixed", 0.2),
                                  ("fixed", float("nan")), ("percentile", 0.9),
                                  ("percentile", 0.25), ("percentile", 1.7)])
def test_compute_tau_matches_reference(mode):
    lam = np.random.default_rng(5).random(101)
    lam[[3, 50]] = [np.nan, np.inf]
    t = tp.compute_tau(lam, tp.TauMode(*mode))
    assert t == jp.compute_tau(lam, jp.TauMode(*mode))
    assert tp.compute_tau(np.array([np.nan]), tp.TauMode(*mode)) == 1e-9


# --------------------------------------------------------------- stage A


@pytest.mark.parametrize("cfg", [
    dict(max_clusters=50, radius_threshold=16.0, batch_size=64),
    dict(max_clusters=4, radius_threshold=1.0, batch_size=32),
    dict(max_clusters=10_000, radius_threshold=1.0),
], ids=["gating", "force-assign", "default-radius"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python-scan"])
def test_stage_a_matches_reference(cfg, native, monkeypatch):
    X = jfix.make_gaussian_blob(200, 0.3).astype(np.float32)
    if not native:
        monkeypatch.setattr(tnative, "incremental_cluster", lambda *a, **k: None)
        monkeypatch.setattr(jnative, "incremental_cluster", lambda *a, **k: None)
    ref = jp.ClusteringStage(jp.ClusteringConfig(**cfg)).execute(X)
    got = tp.ClusteringStage(tp.ClusteringConfig(**cfg), device=CPU).execute(X)
    np.testing.assert_array_equal(got.assignments, ref.assignments)
    for name in ("means", "variances", "counts"):
        np.testing.assert_array_equal(_np(getattr(got.state, name)), np.asarray(getattr(ref.state, name)))
    assert (got.num_items, got.original_dim, got.working_dim) == \
        (ref.num_items, ref.original_dim, ref.working_dim)
    assert (got.assignments >= 0).all() and got.state.num_centroids <= cfg["max_clusters"]


def test_stage_a_python_scan_equals_native(monkeypatch):
    X = jfix.make_gaussian_blob(250, 0.5).astype(np.float32)
    stage = tp.ClusteringStage(tp.ClusteringConfig(max_clusters=30, radius_threshold=9.0), device=CPU)
    cents, assignments, counts, m2 = tnative.incremental_cluster(X, 30, 9.0, "stage_a")
    monkeypatch.setattr(tnative, "incremental_cluster", lambda *a, **k: None)
    out = stage._incremental(X)
    np.testing.assert_array_equal(out[1], assignments)
    np.testing.assert_array_equal(out[2], counts)
    np.testing.assert_array_equal(out[0], cents)
    np.testing.assert_allclose(out[3], m2, rtol=1e-12)


def test_stage_a_projection_trigger():
    data = np.random.default_rng(1).normal(size=(300, 1200)).astype(np.float32)
    cfg = dict(max_clusters=20, radius_threshold=2500.0, projection_threshold=1000, batch_size=128)
    ref = jp.ClusteringStage(jp.ClusteringConfig(**cfg)).execute(data)
    got = tp.ClusteringStage(tp.ClusteringConfig(**cfg), device=CPU).execute(data)
    assert got.projection is not None and got.working_dim == ref.working_dim < 1200
    assert got.state.feature_dim == got.working_dim
    # The projections differ by at most 4 ulp an entry (prng.normal), so
    # the working rows agree closely and the scan decides alike here.
    np.testing.assert_allclose(got.working, np.asarray(ref.working), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got.assignments, ref.assignments)


# -------------------------------------------------------------- stage B0


@pytest.mark.parametrize("scale", [1.0, 100.0, 8.0])
@pytest.mark.parametrize("preset", ["default", "conservative", "strict"])
def test_preflight_matches_reference(scale, preset):
    rng = np.random.default_rng(4)
    means = rng.normal(size=(10, 6)).astype(np.float32)
    means[0] *= scale
    var = rng.uniform(0.5, 1.0, (10, 6)).astype(np.float32)
    var[:, 2] = 0.0
    var[1, 3] = 1e5
    js, ts = _states(means, var)
    ref = (jp.PreflightStage() if preset == "default"
           else jp.PreflightStage(getattr(jp.PreflightConfig, preset)())).execute(js)
    got = (tp.PreflightStage() if preset == "default"
           else tp.PreflightStage(getattr(tp.PreflightConfig, preset)())).execute(ts)
    assert got.was_normalized == ref.was_normalized
    np.testing.assert_allclose(_np(got.normalized_centroids), np.asarray(ref.normalized_centroids),
                               atol=1e-7, rtol=1e-6)
    np.testing.assert_array_equal(_np(got.variances), np.asarray(ref.variances))
    np.testing.assert_array_equal(got.zero_variance_features, ref.zero_variance_features)
    _close_rel(dataclasses.astuple(ref.magnitude_stats), dataclasses.astuple(got.magnitude_stats), 1e-6)


# -------------------------------------------------------------- stage B1


def _same_mst(ref, got):
    assert [(e.u, e.v) for e in got.candidate_edges] == [(e.u, e.v) for e in ref.candidate_edges]
    _close_rel([e.cost for e in ref.candidate_edges], [e.cost for e in got.candidate_edges])
    assert [(e.u, e.v) for e in got.mst_edges] == [(e.u, e.v) for e in ref.mst_edges]
    np.testing.assert_array_equal(got.centroid_order, ref.centroid_order)
    np.testing.assert_array_equal(got.trunk_nodes, ref.trunk_nodes)
    assert got.trunk_edges == ref.trunk_edges and got.nodes_in_mst == ref.nodes_in_mst
    _close_rel(ref.total_weight, got.total_weight)
    _close_rel(ref.thickness, got.thickness, 1e-6)
    assert got.is_connected() == ref.is_connected()


@pytest.mark.parametrize("metric", [tmst.BHATTACHARYYA, tmst.EUCLIDEAN, tmst.SQEUCLIDEAN])
@pytest.mark.parametrize("thickness", [tmst.THICKNESS_MEAN, tmst.THICKNESS_MIN, tmst.THICKNESS_MAX,
                                       tmst.THICKNESS_GEOMETRIC, tmst.THICKNESS_NONE])
def test_mst_matches_reference(state, metric, thickness):
    js, ts = state
    cfg = dict(k_neighbors=4, distance_metric=metric, thickness_weight=thickness)
    _same_mst(jp.MSTStage(jp.MSTConfig(**cfg)).execute(js), tp.MSTStage(tp.MSTConfig(**cfg)).execute(ts))


@pytest.mark.parametrize("preset", ["default", "high_dimensional", "prototype"])
def test_mst_on_a_blob_state_matches_reference(blob_state, preset):
    _, (js, ts) = blob_state
    jc = jp.MSTConfig() if preset == "default" else getattr(jp.MSTConfig, preset)()
    tc = tp.MSTConfig() if preset == "default" else getattr(tp.MSTConfig, preset)()
    _same_mst(jp.MSTStage(jc).execute(js), tp.MSTStage(tc).execute(ts))


def test_mst_edge_helpers():
    e = tmst.Edge(1, 4, 0.5, 0.1, 0.2, 0.07)
    assert e.contains(4) and not e.contains(2)
    assert e.other(1) == 4 and e.other(4) == 1 and e.other(3) is None


def test_nearest_columns_follow_numpy_stable_argsort():
    """Ties (duplicated distances, zeros of both signs) and row blocks."""
    rng = np.random.default_rng(9)
    D = rng.integers(0, 5, (37, 37)).astype(np.float32)
    D[3, :6] = -0.0
    order = np.argsort(D.astype(np.float64), axis=1, kind="stable")
    for blk in (1, 5, 37 * 37):
        ids, vals = tmst.nearest_columns(torch.from_numpy(D), 9, block_elems=blk * 37)
        np.testing.assert_array_equal(ids, order[:, :9])
        np.testing.assert_array_equal(vals, np.take_along_axis(D, order[:, :9], 1).astype(np.float64))


# -------------------------------------------------------------- stage B2


@pytest.mark.parametrize("cfg", [dict(), dict(transition_model="damped", damping=0.8),
                                 dict(transition_model="trunk_aware", trunk_factor=0.3),
                                 dict(process_noise=0.1, observation_noise=0.01),
                                 dict(process_noise=0.001, observation_noise=1.0),
                                 dict(variance_floor=0.2, variance_ceiling=0.3)],
                         ids=["identity", "damped", "trunk", "conservative", "aggressive", "clamped"])
def test_kalman_matches_reference(blob_state, cfg):
    _, (js, ts) = blob_state
    jm, tm = jp.MSTStage().execute(js), tp.MSTStage().execute(ts)
    np.testing.assert_array_equal(tm.centroid_order, jm.centroid_order)
    ref = jp.SmoothingStage(jp.SmoothingConfig(**cfg)).execute(js, jm)
    got = tp.SmoothingStage(tp.SmoothingConfig(**cfg)).execute(ts, tm)
    for name in ("smoothed_means", "smoothed_variances", "filtered_means", "filtered_variances"):
        np.testing.assert_allclose(_np(getattr(got, name)), np.asarray(getattr(ref, name)),
                                   atol=TOL, rtol=0, err_msg=name)
    np.testing.assert_array_equal(_np(got.counts), np.asarray(ref.counts))
    np.testing.assert_allclose(got.smoothing_gains, np.asarray(ref.smoothing_gains), atol=1e-6, rtol=0)
    assert abs(got.variance_reduction - ref.variance_reduction) <= 1e-6
    np.testing.assert_array_equal(got.order, ref.order)
    assert got.summary().split("(")[1] == ref.summary().split("(")[1]
    np.testing.assert_array_equal(_np(got.smoothed_means[-1]), _np(got.filtered_means[-1]))


def test_kalman_on_one_centroid(state):
    js, ts = state
    one_j = jp.CentroidState(js.means[:1], js.variances[:1], js.counts[:1])
    one_t = tp.CentroidState(ts.means[:1], ts.variances[:1], ts.counts[:1])
    ref = jp.SmoothingStage().execute(one_j, jp.MSTStage().execute(one_j))
    got = tp.SmoothingStage().execute(one_t, tp.MSTStage().execute(one_t))
    np.testing.assert_allclose(_np(got.smoothed_variances), np.asarray(ref.smoothed_variances), atol=TOL)
    assert got.smoothing_gains.shape == (0,)


# --------------------------------------------------------------- stage C


@pytest.mark.parametrize("cfg", [dict(), dict(normalize=False), dict(k_neighbors=3),
                                 dict(k_neighbors=40), dict(weight_threshold=0.5)],
                         ids=["default", "unnormalised", "k3", "k40", "threshold"])
def test_stage_c_matches_reference(blob_state, cfg):
    _, (js, ts) = blob_state
    ref = jp.LaplacianStage(jp.LaplacianConfig(**cfg)).execute(js)
    got = tp.LaplacianStage(tp.LaplacianConfig(**cfg)).execute(ts)
    L, Lr = got.matrix.numpy(), np.asarray(ref.matrix)
    assert ((np.abs(L) > 1e-9) == (np.abs(Lr) > 1e-9)).all()
    np.testing.assert_allclose(L, Lr, atol=TOL, rtol=0)
    assert got.nnz == ref.nnz and got.n_features == ref.n_features
    np.testing.assert_allclose(got.degrees, np.asarray(ref.degrees), atol=TOL, rtol=0)
    assert got.summary() == ref.summary()
    if cfg.get("normalize") is False:
        np.testing.assert_allclose(L.sum(axis=1), 0.0, atol=1e-5)


# --------------------------------------------------------------- stage D


def test_stage_d_matches_reference(blob_state):
    X, (js, ts) = blob_state
    lap = tp.LaplacianStage().execute(ts)
    L = lap.matrix.numpy()
    ref_all = [np.asarray(f(jnp.asarray(L), jnp.asarray(X)))
               for f in (jspec.compute_lambdas, jspec.rayleigh_quotient_batch,
                         jspec.dirichlet_dispersion_batch)]
    got_all = [_np(f(lap.matrix, X)) for f in (tspec.compute_lambdas, tspec.rayleigh_quotient_batch,
                                               tspec.dirichlet_dispersion_batch)]
    for r, g in zip(ref_all, got_all):
        _close_rel(r, g)
    assert got_all[0].dtype == np.float64
    lam = tspec.compute_tau_mode(lap, X.ravel(), X.shape[0], X.shape[1])
    np.testing.assert_array_equal(lam, got_all[0])
    # The float64 oracle's stage D on the same L.
    _close_rel(osg.stage_d_lambdas(L, X), lam)


def test_stage_d_known_cases():
    L = np.array([[1.0, -1.0], [-1.0, 1.0]], np.float32)
    x = np.array([[1.0, -1.0], [1.0, 1.0], [0.0, 0.0]], np.float32)
    r = tspec.rayleigh_quotient_batch(torch.from_numpy(L), x).numpy()
    np.testing.assert_allclose(r, [2.0, 0.0, 0.0], atol=1e-6)
    d = tspec.dirichlet_dispersion_batch(torch.from_numpy(L), x).numpy()
    assert d[1] == 0.0 and d[2] == 0.0 and np.isfinite(d).all()


# ------------------------------------------------------------- the chain


def _same_result(ref, got):
    np.testing.assert_array_equal(got.assignments, ref.assignments)
    np.testing.assert_array_equal(got.centroid_positions, ref.centroid_positions)
    _same_mst(ref.mst, got.mst)
    np.testing.assert_allclose(_np(got.state.means), np.asarray(ref.state.means), atol=TOL, rtol=0)
    np.testing.assert_allclose(_np(got.state.variances), np.asarray(ref.state.variances),
                               atol=TOL, rtol=0)
    L, Lr = _np(got.laplacian.matrix), np.asarray(ref.laplacian.matrix)
    assert ((np.abs(L) > 1e-9) == (np.abs(Lr) > 1e-9)).all()
    np.testing.assert_allclose(L, Lr, atol=TOL, rtol=0)
    _close_rel(ref.lambdas, got.lambdas)
    _close_rel(ref.tau, got.tau)
    assert set(got.timings) == set(ref.timings) == {
        "A:clustering", "B0:preflight", "B1:mst", "B2:kalman", "C:laplacian", "D:spectral"}


@pytest.mark.parametrize("case", [
    (150, dict(clustering=dict(max_clusters=20, radius_threshold=16.0, batch_size=64))),
    (300, dict(clustering=dict(max_clusters=60, radius_threshold=4.0),
               smoothing=dict(transition_model="trunk_aware", trunk_factor=0.3),
               taumode=("percentile", 0.9))),
    (100, dict(clustering=dict(max_clusters=12, radius_threshold=16.0),
               laplacian=dict(normalize=False), mst=dict(distance_metric="sqeuclidean"))),
], ids=["blob150", "blob300-trunk", "blob100-unnormalised"])
def test_build_matches_reference(case):
    n, spec = case

    def config(mod):
        kw = {}
        for key, cls in (("clustering", "ClusteringConfig"), ("mst", "MSTConfig"),
                         ("smoothing", "SmoothingConfig"), ("laplacian", "LaplacianConfig")):
            if key in spec:
                kw[key] = getattr(mod, cls)(**spec[key])
        if "taumode" in spec:
            kw["taumode"] = mod.TauMode(*spec["taumode"])
        return mod.PipelineConfig(**kw)

    X = jfix.make_gaussian_blob(n, 0.4).astype(np.float32)
    ref = jp.build(X, config(jp))
    got = tp.build(X, config(tp), device=CPU)
    _same_result(ref, got)
    mode = config(tp).taumode
    assert got.tau == jp.compute_tau(got.lambdas, jp.TauMode(mode.mode, mode.param))


def test_chain_matches_the_staged_oracle():
    """The reference's ``test_staged_pipeline_parity`` on the port: stage A
    once, then B0 → D in the port and in the float64 oracle."""
    rng = np.random.default_rng(9)
    centers = rng.normal(size=(8, 24)) * 4.0
    rows = (centers[rng.integers(0, 8, 400)] + rng.normal(size=(400, 24))).astype(np.float32)
    a_out = tp.ClusteringStage(tp.ClusteringConfig(max_clusters=24, radius_threshold=30.0),
                               device=CPU).execute(rows)
    b0 = tp.PreflightStage().execute(a_out.state)
    st = tp.CentroidState(means=b0.normalized_centroids, variances=b0.variances,
                          counts=a_out.state.counts)
    mst = tp.MSTStage().execute(st)
    kal = tp.SmoothingStage().execute(st, mst)
    lap = tp.LaplacianStage().execute(kal.to_centroid_state())
    lam = tspec.compute_lambdas(lap.matrix, rows)
    res = osg.run_staged(_np(a_out.state.means).astype(np.float64),
                         _np(a_out.state.variances).astype(np.float64), rows)
    assert res.was_normalized == b0.was_normalized
    np.testing.assert_allclose(_np(b0.normalized_centroids), res.preflight_means, atol=1e-5)
    np.testing.assert_allclose(_np(b0.variances), res.preflight_vars, atol=1e-6)
    assert {frozenset((e.u, e.v)) for e in mst.mst_edges} == \
        {frozenset((u, v)) for u, v, _ in res.mst.mst_edges}
    np.testing.assert_array_equal(mst.centroid_order, res.mst.centroid_order)
    assert abs(mst.total_weight - res.mst.total_weight) < 1e-4 * max(res.mst.total_weight, 1.0)
    np.testing.assert_allclose(_np(kal.smoothed_means), res.smoothed_means, atol=1e-4)
    np.testing.assert_allclose(_np(kal.smoothed_variances), res.smoothed_vars, atol=1e-5)
    L = _np(lap.matrix)
    assert ((np.abs(L) > 1e-9) ^ (np.abs(res.L) > 1e-9)).sum() == 0
    np.testing.assert_allclose(L, res.L, atol=1e-4)
    np.testing.assert_allclose(lam, res.lambdas, atol=5e-4, rtol=1e-3)
    # The port's chain holds the oracle's λ within 1e-5·max(|λ|, 1).
    _close_rel(res.lambdas, lam)
    _close_rel(osg.stage_d_lambdas(L, rows), lam)


def test_disconnected_mst_raises_as_the_reference():
    """Radius 1.0 against squared distances near 55 makes every row its
    own centroid (C = 1,000); the k = 8 candidate graph is disconnected,
    the traversal order stops short of C and the item mapping raises in
    both packages."""
    X = jfix.make_energy_test_dataset(1000, 16, seed=44)
    with pytest.raises(IndexError) as ref:
        jp.build(X)
    with pytest.raises(IndexError) as got:
        tp.build(X, device=CPU)
    assert str(got.value) == str(ref.value) == "index 890 is out of bounds for axis 0 with size 798"


def test_thick_centroids_split_off_at_small_k():
    """Stage A's force-assignment leaves a few centroids holding far rows
    (thickness ≈ 33 on ``make_gaussian_hd`` past 100,000 rows, against
    0.1 for singletons). Under the Bhattacharyya metric their k nearest
    are one another, so with more of them than k the candidate graph
    splits and Prim from node 0 misses them: both packages alike. Here
    20 thick centroids among 200 thin ones: k = 8 reaches the 200 thin
    ones, k = 32 all 220."""
    rng = np.random.default_rng(11)
    means = rng.normal(size=(220, 10))
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    var = np.full((220, 10), 0.1001)
    thick = rng.choice(np.arange(1, 220), 20, replace=False)
    var[thick] = rng.uniform(20.0, 40.0, (20, 10))
    js, ts = _states(means.astype(np.float32), var.astype(np.float32))
    for k, reached in ((8, 200), (32, 220)):
        ref = jp.MSTStage(jp.MSTConfig(k_neighbors=k)).execute(js)
        got = tp.MSTStage(tp.MSTConfig(k_neighbors=k)).execute(ts)
        _same_mst(ref, got)
        assert got.nodes_in_mst == reached
        assert got.is_connected() == (reached == 220)


@pytest.mark.parametrize("c, empty", [(40, False), (4000, True)])
def test_stage_c_graph_empties_as_centroids_grow(c, empty):
    """Stage C sums the Bhattacharyya distance of two features' profiles
    over all C centroids, and keeps an edge only where exp(−D) > 1e-9: with
    enough centroids no pair qualifies, W = 0 and L = 0, in both packages
    (the default cap of 10,000 does this on ``make_gaussian_hd``)."""
    rng = np.random.default_rng(12)
    means = rng.normal(size=(c, 12))
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    var = rng.uniform(0.04, 0.12, (c, 12))
    js, ts = _states(means.astype(np.float32), var.astype(np.float32))
    ref = jp.LaplacianStage().execute(js)
    got = tp.LaplacianStage().execute(ts)
    assert got.nnz == ref.nnz and (got.nnz == 0) == empty
    np.testing.assert_allclose(got.matrix.numpy(), np.asarray(ref.matrix), atol=TOL, rtol=0)


def test_mesh_waits_for_the_parallel_port():
    """``build(mesh=...)``, which waited for the port of ``parallel/``, now
    shards stage D over the mesh: λ equal to the unsharded build's (the
    Dirichlet total summed over the gathered rows in row order, as on one
    device) and to the reference's mesh build within its relative
    tolerance; the other stages are the same."""
    from matternet_rs_tpu.parallel import make_mesh as jmake_mesh
    from matternet_rs_tpu_torch.parallel import make_mesh

    X = jfix.make_gaussian_blob(150, 0.4).astype(np.float32)
    cfg = dict(clustering=dict(max_clusters=20, radius_threshold=16.0, batch_size=64))
    one = tp.build(X, tp.PipelineConfig(clustering=tp.ClusteringConfig(**cfg["clustering"])),
                   device=CPU)
    for slots in (1, 4, 8):
        got = tp.build(X, tp.PipelineConfig(clustering=tp.ClusteringConfig(**cfg["clustering"])),
                       mesh=make_mesh(slots, devices=[CPU] * slots), device=CPU)
        assert np.array_equal(got.lambdas, one.lambdas), slots
        assert got.tau == one.tau
    ref = jp.build(X, jp.PipelineConfig(clustering=jp.ClusteringConfig(**cfg["clustering"])),
                   mesh=jmake_mesh(8))
    _close_rel(ref.lambdas, got.lambdas)


def test_build_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: build takes it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.build(np.ones((4, 3), np.float32))


def test_save_and_load_result(tmp_path):
    X = jfix.make_gaussian_blob(100, 0.4).astype(np.float32)
    cfg = tp.PipelineConfig(clustering=tp.ClusteringConfig(max_clusters=12, radius_threshold=16.0))
    res = tp.build(X, cfg, device=CPU)
    trun.save_result(res, tmp_path, "run")
    for loaded in (trun.load_result_arrays(tmp_path, "run"), jrun.load_result_arrays(tmp_path, "run")):
        np.testing.assert_array_equal(loaded["means"], res.state.means.numpy().astype(np.float64))
        np.testing.assert_array_equal(loaded["variances"],
                                      res.state.variances.numpy().astype(np.float64))
        np.testing.assert_array_equal(loaded["laplacian"],
                                      res.laplacian.matrix.numpy().astype(np.float64))
        np.testing.assert_array_equal(loaded["lambdas"], res.lambdas)
        np.testing.assert_array_equal(loaded["order"], res.mst.centroid_order)


def test_public_names_match_reference():
    import inspect

    assert sorted(tp.__all__) == sorted(jp.__all__)
    for mod_t, mod_j in ((tp.centroid, jp.centroid), (tp.clustering, jp.clustering),
                         (tp.preflight, jp.preflight), (tmst, jmst), (tsm, jsm),
                         (tp.laplacian, jp.laplacian), (tspec, jspec), (trun, jrun),
                         (tp.taumode, jp.taumode)):
        def public(m):
            return {n for n, v in vars(m).items() if not n.startswith("_")
                    and (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == m.__name__}
        assert public(mod_j) <= public(mod_t), public(mod_j) - public(mod_t)
    for name in ("VAR_FLOOR", "bhattacharyya_pairwise", "cosine_similarity", "pairwise_euclidean"):
        assert hasattr(tdist, name)
