"""Port vs reference: the four API repairs (``build(device_rows=)``,
``native.incremental_cluster(mode, keep_mask)`` with its ``m2``,
``l2_norms(axis, keepdims)``, ``StageTimer.stage(sync=)``), ``ArrowItem``,
item access, row mutation and append in eigen and energy mode, on
JAX-CPU and torch-CPU with the same numpy inputs.

Tolerances: the native scan and ``l2_norms`` equal (one C++ source, the
same float32 sums); rows after a mutation equal; normalised λ and its
stats within 1e-5·max(|λ|, 1) (the taumode tests' bound); search ids equal
up to the near-tie rule and scores within 1e-5 (``utils/parity.py``); a
mutated row's returned score equal to its exact blended score within
1e-5; energy-mode append: nearest sub-centroids equal, each new row's λ
its sub-centroid's, which agree with the reference's within 2e-4 (ROADMAP
Queue 3: the sub-centroid λ of the two energy builds), item norms within
1e-6 relative.
"""

import copy
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu import energymaps as jem
from matternet_rs_tpu import native as jnative
from matternet_rs_tpu.builder import ArrowSpaceBuilder as JBuilder
from matternet_rs_tpu.core import ArrowItem as JArrowItem
from matternet_rs_tpu.ops import distance as jdist
from matternet_rs_tpu.utils.fixtures import make_gaussian_blob

from matternet_rs_tpu_torch import energymaps as tem
from matternet_rs_tpu_torch import native as tnative
from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder as TBuilder
from matternet_rs_tpu_torch.core import ArrowItem as TArrowItem
from matternet_rs_tpu_torch.ops import distance as tdist
from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops import taumode as tmo
from matternet_rs_tpu_torch.ops._mm import mm_bf16
from matternet_rs_tpu_torch.ops.kernels.tilemax import blend
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset
from matternet_rs_tpu_torch.utils.parity import topk_mismatches
from matternet_rs_tpu_torch.utils.profiling import StageTimer

CPU = "cpu"
K = 10
TOL = 1e-5
# Every scan tier of search_batch (bf16_rescored behind its gate).
TIERS = (False, True, "int8", "int8_rescored", "bf16_rescored", "bf16x3_rescored", "auto",
         "int8_auto")


def _close(ref, got, tol=TOL):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return np.all(np.abs(ref - got) <= tol * np.maximum(1.0, np.abs(ref)))


def _small(b, max_clusters=20, radius=4.0):
    return (b.with_lambda_graph(1.0, 6).with_sparsity_check(False)
            .with_cluster_params(max_clusters=max_clusters, radius=radius)
            .with_deterministic_clustering(True))


@pytest.fixture(scope="module")
def blob():
    return make_gaussian_blob(150, 0.4).astype(np.float32)


@pytest.fixture(scope="module")
def built():
    X = make_energy_test_dataset(900, 24, seed=31).astype(np.float32)
    ja, jgl = _small(JBuilder(), 30, 6.0).build(X)
    ta, tgl = _small(TBuilder(device=CPU), 30, 6.0).build(X)
    return X, ja, jgl, ta, tgl


def _same_index(ja, ta):
    np.testing.assert_array_equal(ta.data.numpy(), np.asarray(ja.data))
    for s in ("min_lambdas", "max_lambdas", "range_lambdas"):
        assert _close(getattr(ja, s), getattr(ta, s)), s
    assert _close(np.asarray(ja.lambdas), ta.lambdas.numpy())
    assert ta.nitems == ja.nitems


def _same_search(ja, jgl, ta, tgl, Q):
    ref_i, ref_s = ja.search_batch(Q, jgl, K + 1)
    got_i, got_s = ta.search_batch(Q, tgl, K)
    assert not topk_mismatches(ref_i, ref_s, got_i, got_s)


# ------------------------------------------------------------ the repairs


def test_device_resident_rebuild_matches_plain_build(blob):
    """The reference's case (``tests/test_builder.py``): a rebuild on a
    previous build's data reuses that tensor and builds the same index."""
    a1, g1 = _small(TBuilder(device=CPU)).build(blob)
    a2, g2 = _small(TBuilder(device=CPU)).build(blob, device_rows=a1.data)
    assert a2.data is a1.data
    assert torch.equal(a1.lambdas, a2.lambdas)
    assert torch.equal(g1.dense(), g2.dense())
    q = blob[7]
    ql1, ql2 = a1.prepare_query_item(q, g1), a2.prepare_query_item(q, g2)
    assert ql1 == ql2
    assert a1.search_lambda_aware(q, ql1, 5) == a2.search_lambda_aware(q, ql2, 5)
    with pytest.raises(ValueError, match="device_rows shape"):
        _small(TBuilder(device=CPU)).build(blob, device_rows=torch.zeros((3, 3)))
    with pytest.raises(ValueError, match="device_rows dtype"):
        _small(TBuilder(device=CPU)).build(blob, device_rows=a1.data.to(torch.bfloat16))
    ja, jg = _small(JBuilder()).build(blob, device_rows=jnp.asarray(blob))
    assert _close(np.asarray(ja.lambdas), a2.lambdas.numpy())


def test_start_clustering_takes_device_rows(blob):
    t = torch.from_numpy(blob.copy())
    sp, cents = _small(TBuilder(device=CPU)).start_clustering(blob, device_rows=t)
    assert sp.data is t
    _, jcents = _small(JBuilder()).start_clustering(blob, device_rows=jnp.asarray(blob))
    np.testing.assert_array_equal(cents, np.asarray(jcents))


@pytest.mark.parametrize("mode", ["legacy", "stage_a"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "keep-mask"])
def test_native_incremental_cluster_modes_and_m2(mode, masked):
    X = make_gaussian_blob(400, 0.6).astype(np.float32)
    keep = (np.random.default_rng(2).random(400) < 0.7).astype(np.uint8) if masked else None
    ref = jnative.incremental_cluster(X, 25, 9.0, mode, keep)
    got = tnative.incremental_cluster(X, 25, 9.0, mode, keep)
    assert ref is not None and got is not None and len(got) == 4
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    assert got[3].dtype == np.float64 and got[3].shape == got[0].shape
    kw = tnative.incremental_cluster(X, 25, 9.0, mode=mode, keep_mask=keep)
    for r, g in zip(ref, kw):
        np.testing.assert_array_equal(g, r)


def test_native_incremental_cluster_rejects_an_empty_budget():
    X = np.ones((4, 3), np.float32)
    for fn in (jnative.incremental_cluster, tnative.incremental_cluster):
        with pytest.raises(ValueError, match="max_clusters must be >= 1"):
            fn(X, 0, 1.0, "stage_a")


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("keepdims", [False, True])
def test_l2_norms_takes_the_reference_names(axis, keepdims):
    x = np.random.default_rng(3).normal(size=(7, 5)).astype(np.float32)
    ref = np.asarray(jdist.l2_norms(jnp.asarray(x), axis=axis, keepdims=keepdims))
    got = tdist.l2_norms(torch.from_numpy(x), axis=axis, keepdims=keepdims).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_stage_timer_collects_and_reports():
    """The reference's case (``tests/test_profiling.py``), ``sync=`` a
    tensor."""
    t = StageTimer()
    with t.stage("a", items=100):
        sum(range(1000))
    with t.stage("b", sync=torch.ones(4) * 2):
        pass
    with t.stage("c", sync=[torch.ones(2), {"x": torch.zeros(1)}, None]):
        pass
    assert list(t.as_dict()) == ["a", "b", "c"]
    assert t.total() >= 0
    report = t.report()
    assert "a:" in report and "total:" in report
    assert t.timings[0].items_per_sec is not None and t.timings[1].items_per_sec is None


def test_builder_logs_stage_throughput(blob, caplog):
    with caplog.at_level(logging.INFO, logger="matternet_rs_tpu_torch"):
        b = _small(TBuilder(device=CPU))
        b.build(blob)
    assert set(b.last_stage_timings) == {"clustering", "laplacian", "taumode", "sorted-index"}
    lines = [r.message for r in caplog.records if r.message.startswith("stage ")]
    assert len(lines) >= 4 and any("items/s" in ln for ln in lines)


# ------------------------------------------------------- items and access


def test_arrow_item_matches_reference():
    a, b = [1.0, 2.0, 3.0], [4.0, 5.0, 6.0]
    ja, jb = JArrowItem(a, 0.5), JArrowItem(b, 0.6)
    ta, tb = TArrowItem(a, 0.5), TArrowItem(b, 0.6)
    assert ta.norm() == ja.norm()
    for name in ("dot", "cosine_similarity", "euclidean_distance", "lambda_component_similarity"):
        assert getattr(ta, name)(tb) == getattr(ja, name)(jb), name
    assert ta.lambda_similarity(tb, 0.7) == ja.lambda_similarity(jb, 0.7)
    assert ta.cosine_similarity(np.zeros(3)) == ja.cosine_similarity(np.zeros(3)) == 0.0
    ta.scale(2.0), ja.scale(2.0)
    ta.add(tb), ja.add(jb)
    np.testing.assert_array_equal(ta.item, ja.item)
    assert len(ta) == 3
    with pytest.raises(ValueError, match="Dimension mismatch"):
        ta.dot(TArrowItem([1.0]))


def test_get_item_and_cluster_of(built):
    X, ja, jgl, ta, tgl = built
    for i in (0, 17, len(X) - 1):
        row, lam = ta.get_item(i)
        jrow, jlam = ja.get_item(i)
        np.testing.assert_array_equal(row, jrow)
        assert _close(jlam, lam)
        assert ta.cluster_of(i) == ja.cluster_of(i)
    assert ta.cluster_of(len(X) + 5) is None and ja.cluster_of(len(X) + 5) is None
    sp = copy.deepcopy(ta)
    sp.cluster_assignments = np.array([3, -1])
    assert sp.cluster_of(0) == 3 and sp.cluster_of(1) is None


# ---------------------------------------------------------------- mutation


def _mutated(built, op):
    X, ja, jgl, ta, tgl = built
    ja, ta = copy.deepcopy(ja), copy.deepcopy(ta)
    ta.build_lambdas_sorted()
    for sp, gl in ((ja, jgl), (ta, tgl)):
        if op == "set_item":
            sp.set_item(5, X[9] * 1.5)
            sp.recompute_lambdas(gl)
        elif op == "scale_item":
            sp.scale_item(5, 0.3, gl)
        elif op == "superpose_items":
            sp.superpose_items(5, 11, gl)
        else:
            sp.mul_items(5, 11, gl)
    return X, ja, jgl, ta, tgl


@pytest.mark.parametrize("op", ["set_item", "scale_item", "superpose_items", "mul_items"])
def test_mutations_match_reference(built, op):
    X, ja, jgl, ta, tgl = _mutated(built, op)
    _same_index(ja, ta)
    assert not torch.equal(ta.data[5], torch.from_numpy(X[5]))
    np.testing.assert_array_equal(ta.lambdas_sorted.sorted_indices,
                                  np.asarray(ja.lambdas_sorted.sorted_indices))
    Q = np.concatenate([ta.data[5:6].numpy(), X[[3, 200, 777]]])
    _same_search(ja, jgl, ta, tgl, Q)


def test_mutation_assigns_new_tensors_and_clears_caches(built):
    _, _, _, ta, tgl = built
    sp = copy.deepcopy(ta)
    sp.enable_quantized_scan()
    sp.enable_int8_scan()
    _ = sp.norms
    data, lams = sp.data, sp.lambdas
    sp.scale_item(2, 2.0, tgl)
    assert sp.data is not data and sp.lambdas is not lams
    assert sp._norms is None and sp._data_bf16 is None and sp._i8_pair is None
    assert torch.equal(sp.data[2], data[2] * 2.0) and torch.equal(sp.data[3], data[3])


def test_mutations_reject_bad_indices_and_shapes(built):
    _, ja, jgl, ta, tgl = built
    for sp, gl in ((ja, jgl), (ta, tgl)):
        with pytest.raises(ValueError, match="out of bounds"):
            sp.set_item(sp.nitems, np.zeros(sp.nfeatures))
        with pytest.raises(ValueError, match="shape"):
            sp.set_item(0, np.zeros(sp.nfeatures + 1))
        with pytest.raises(ValueError, match="out of bounds"):
            sp.superpose_items(-1, 0, gl)
        with pytest.raises(ValueError, match="out of bounds"):
            sp.scale_item(sp.nitems, 1.0, gl)


@pytest.fixture(scope="module")
def fused_index():
    """A port index past ``FUSED_TILEMAX_MIN_N`` rows, where the exact tier
    takes the fused route and the rescored tiers the maxima-first route
    (the kernels' plain versions on the CPU), and kernel A's route builds
    the λ."""
    X = make_energy_test_dataset(40_000, 16, seed=12).astype(np.float32)
    ta, tgl = (TBuilder(device=CPU).with_lambda_graph(1.0, 6).with_sparsity_check(False)
               .with_cluster_params(max_clusters=40, radius=6.0).with_sampling(None).build(X))
    return X, ta, tgl


@pytest.mark.parametrize("n", [900, 40_000], ids=["flat", "fused"])
def test_set_item_then_every_tier_serves_the_new_row(built, fused_index, n):
    """Each tier first builds its caches (norms, bf16 copy, int8 sketch),
    then row r becomes 1.5 × row s: querying the new row must return r with
    its exact blended score (``quantized=True``: the blend of the new row's
    bf16 dot, the score that tier returns), which a stale norm, bf16 copy
    or sketch would miss."""
    if n == 900:
        X, sp, gl = built[0], copy.deepcopy(built[3]), built[4]
    else:
        X, sp, gl = fused_index[0], copy.deepcopy(fused_index[1]), fused_index[2]
    r, s = 123, 4567 % len(X)
    Q = X[[r, 7, 8, 9]]
    for tier in TIERS:
        sp.search_batch(Q, gl, K, quantized=tier, allow_low_recall=True)
    sp.set_item(r, X[s] * 1.5)
    sp.recompute_lambdas(gl)
    q = sp.data[r].numpy()[None, :]
    raw = sp.search_batch(q, gl, K, return_raw=True)[2]
    ql = torch.clamp((torch.from_numpy(raw) - sp.min_lambdas) / sp.range_lambdas, 0.0, 1.0)
    qt = torch.from_numpy(q)
    denom = sp.norms[r] * torch.sqrt(torch.sum(qt * qt))
    own = blend(torch.sum(sp.data[r] * qt[0])[None], denom, sp.lambdas[r], ql, 0.7)
    # quantized=True returns the bf16 copy's scores: those of the new row.
    own_bf16 = blend(mm_bf16(sp.data[r:r + 1], qt.T)[0], denom, sp.lambdas[r], ql, 0.7)
    for tier in TIERS:
        idx, sc = sp.search_batch(q, gl, K, quantized=tier, allow_low_recall=True)
        want = float((own_bf16 if tier is True else own)[0])
        assert r in idx[0], tier
        pos = list(idx[0]).index(r)
        assert abs(float(sc[0, pos]) - want) <= TOL, tier
        assert float(sc[0, 0]) >= want - TOL, tier


# ------------------------------------------------------------------ append


@pytest.mark.parametrize("n_new", [40, 32_768], ids=["closed-form", "kernel-route"])
def test_add_items_eigen_matches_reference(built, n_new):
    """New rows' λ from the existing graph and normalisation, clamped;
    32,768 new rows take kernel A's route (its plain version here)."""
    X, ja, jgl, ta, tgl = built
    ja, ta = copy.deepcopy(ja), copy.deepcopy(ta)
    new = (X[np.arange(n_new) % len(X)]
           + np.random.default_rng(n_new).normal(0, 0.3, (n_new, X.shape[1]))).astype(np.float32)
    ja.add_items(new, jgl)
    kernels.reset_launches()
    ta.add_items(new, tgl)
    assert kernels.launch_counts()["taumode"] == 0          # the CPU: plain versions only
    _same_index(ja, ta)
    lam_new = ta.lambdas[len(X):].numpy()
    assert lam_new.min() >= 0.0 and lam_new.max() <= 1.0
    raw = tmo.taumode_lambdas(torch.from_numpy(new), tgl.matrix)
    ref = torch.clamp((raw - ta.min_lambdas) / ta.range_lambdas, 0.0, 1.0).numpy()
    assert _close(ref, lam_new)
    np.testing.assert_array_equal(ta.lambdas_sorted.sorted_indices.shape, (len(X) + n_new,))
    _same_search(ja, jgl, ta, tgl, new[:6])
    idx, _ = ta.search_batch(new[:6], tgl, 1)
    assert list(idx[:, 0]) == list(range(len(X), len(X) + 6))


def test_add_items_rejects_another_width(built):
    _, ja, jgl, ta, tgl = built
    for sp, gl in ((ja, jgl), (ta, tgl)):
        with pytest.raises(ValueError, match="dimension"):
            copy.deepcopy(sp).add_items(np.ones((1, 3), np.float32), gl)


def test_add_items_single_row_and_quantised_caches(built):
    X, _, _, ta, tgl = built
    sp = copy.deepcopy(ta)
    sp.search_batch(X[:2], tgl, K, quantized="int8")
    sp.add_items(X[0] + 0.01, tgl)
    assert sp.nitems == len(X) + 1 and sp._i8_pair is None
    idx, _ = sp.search_batch(X[:1] + 0.01, tgl, 2, quantized="int8")
    assert len(X) in idx[0]


@pytest.fixture(scope="module")
def energy():
    X = make_energy_test_dataset(600, 32, seed=7).astype(np.float32)
    params = dict(optical_tokens=16, neighbor_k=5, candidate_m=8)

    def builder(cls, **kw):
        return (cls(**kw).with_lambda_graph(1.0, 5).with_sparsity_check(False)
                .with_cluster_params(max_clusters=40, radius=4.0).with_dims_reduction(True)
                .with_seed(9))

    ja, jg = builder(JBuilder).build_energy(X, jem.EnergyParams(**params))
    ta, tg = builder(TBuilder, device=CPU).build_energy(X, tem.EnergyParams(**params))
    return X, ja, jg, ta, tg


def test_add_items_energy_matches_reference(energy):
    X, ja, jg, ta, tg = energy
    ja, ta = copy.deepcopy(ja), copy.deepcopy(ta)
    np.testing.assert_allclose(ta.sub_centroids.numpy(), np.asarray(ja.sub_centroids), atol=1e-5)
    new = (X[:50] + np.random.default_rng(1).normal(0, 0.2, (50, X.shape[1]))).astype(np.float32)
    ja.add_items(new, jg)
    ta.add_items(new, tg)
    n0 = len(X)
    np.testing.assert_array_equal(ta.centroid_map[n0:], np.asarray(ja.centroid_map)[n0:])
    sc = ta.subcentroid_lambdas.astype(np.float32)
    np.testing.assert_array_equal(ta.lambdas[n0:].numpy(), sc[ta.centroid_map[n0:]])
    assert _close(np.asarray(ja.lambdas)[n0:], ta.lambdas[n0:].numpy(), 2e-4)
    np.testing.assert_allclose(ta.item_norms[n0:].numpy(), np.linalg.norm(new, axis=1), rtol=1e-6)
    assert ta.item_norms.shape[0] == ta.nitems == n0 + 50 == len(ta.centroid_map)


def test_set_item_refreshes_energy_item_norms(energy):
    X, ja, jg, ta, tg = energy
    ja, ta = copy.deepcopy(ja), copy.deepcopy(ta)
    ja.set_item(3, X[3] * 2.0)
    ta.set_item(3, X[3] * 2.0)
    np.testing.assert_allclose(ta.item_norms.numpy(), np.asarray(ja.item_norms), rtol=1e-6)
    assert abs(float(ta.item_norms[3]) - 2.0 * float(np.linalg.norm(X[3]))) <= 1e-5 * float(ta.item_norms[3])
