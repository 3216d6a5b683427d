"""k-means, the optimal-k heuristics and the incremental clustering paths of
``matternet_rs_tpu_torch.clustering`` against the reference in the same
process, on the CPU.

k-means++ draws its seeds from the port's threefry stream, so the picks
are the reference's rows; Lloyd's iterations from those seeds give equal
assignments and centroids within 1e-5 where no row lies within float32
rounding of two centroids. Where one does (clusters split inside a uniform
cube, as ``make_energy_test_dataset`` at k = 15), the expanded-form
distance can rank the two centroids either way in either package; one
flipped row moves a centroid and the runs part. The test below shows that
every assignment that differs from the same seeds is such a near tie.

Tolerances: CH score and the pilot radius 1e-5 relative; bounds, k and
cluster counts equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matternet_rs_tpu import builder as jbuilder
from matternet_rs_tpu import clustering as jc
from matternet_rs_tpu.utils.fixtures import make_gaussian_cliques_multi

from matternet_rs_tpu_torch import builder as tbuilder
from matternet_rs_tpu_torch import clustering as tc
from matternet_rs_tpu_torch.sampling import make_sampler
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset, make_gaussian_blob

SEED = 42


def _rel_close(ref, got, tol=1e-5):
    return abs(float(ref) - float(got)) <= tol * max(1.0, abs(float(ref)))


DATA = {
    "cliques300": lambda: make_gaussian_cliques_multi(300, 0.5, 5, 10, seed=9),
    "blob1500": lambda: make_gaussian_blob(1500, 0.4),
    "cliques1200": lambda: make_gaussian_cliques_multi(1200, 0.5, 6, 12, seed=4),
}


@pytest.fixture(scope="module", params=sorted(DATA))
def data(request):
    return request.param, DATA[request.param]().astype(np.float32)


@pytest.mark.parametrize("k,seed", [(3, 0), (5, 1), (8, 2), (13, 5), (13, 2**32 + 3)])
def test_kmeanspp_picks_the_reference_rows(data, k, seed):
    _, X = data
    _, ref = jc._kmeans_jit(jnp.asarray(X), k, 0, jnp.uint32(seed & 0xFFFFFFFF))
    got = tc.kmeanspp_init(torch.from_numpy(X), k, seed).numpy()
    assert np.array_equal(np.asarray(ref), got)


@pytest.mark.parametrize("k,seed", [(5, 0), (10, 7), (13, 3)])
def test_kmeans_lloyd_from_the_shared_seeds(data, k, seed):
    _, X = data
    ra, rc = jc.kmeans_lloyd(X, k, 20, seed)
    ga, gc = tc.kmeans_lloyd(X, k, 20, seed, device="cpu")
    assert np.array_equal(ra, ga)
    assert np.abs(rc - gc).max() <= 1e-5 * max(1.0, np.abs(rc).max())


def test_lloyd_assignments_differ_only_at_near_ties():
    """From the same seeds (equal picks), one assignment step on data with
    near ties: every row assigned otherwise than by the reference has its
    two nearest centroids within the expanded form's float32 error."""
    X = make_energy_test_dataset(2000, 8, seed=3).astype(np.float32)
    for k, seed in ((15, 100_042), (10, 100_005), (20, 3)):
        ref_a, ref_c = jc._kmeans_jit(jnp.asarray(X), k, 0, jnp.uint32(seed))
        init = tc.kmeanspp_init(torch.from_numpy(X), k, seed)
        assert np.array_equal(np.asarray(ref_c), init.numpy())
        got_a, _ = tc.lloyd(torch.from_numpy(X), init, 0)
        ref_a, got_a = np.asarray(ref_a), got_a.numpy()
        c = init.numpy().astype(np.float64)
        x = X.astype(np.float64)
        d = ((x[:, None, :] - c[None]) ** 2).sum(-1)
        scale = (x * x).sum(-1)[:, None] + (c * c).sum(-1)[None, :]
        for i in np.nonzero(ref_a != got_a)[0]:
            gap = abs(d[i, ref_a[i]] - d[i, got_a[i]])
            bound = 8 * np.finfo(np.float32).eps * max(scale[i, ref_a[i]], scale[i, got_a[i]])
            assert gap <= bound, (k, seed, i, gap, bound)


def test_kmeans_clamps_k_and_takes_a_tensor():
    X = make_gaussian_blob(12, 0.3).astype(np.float32)
    ra, rc = jc.kmeans_lloyd(X, 50, 5, 1)
    ga, gc = tc.kmeans_lloyd(torch.from_numpy(X), 50, 5, 1)
    assert gc.shape == rc.shape == (12, 10) and np.array_equal(ra, ga)


def test_calinski_harabasz_score(data):
    _, X = data
    for k, seed in ((4, 0), (9, 3)):
        a, _ = jc.kmeans_lloyd(X, k, 20, seed)
        assert _rel_close(jc.calinski_harabasz_score(X, a, k),
                          tc.calinski_harabasz_score(X, a, k, device="cpu"))
    a = np.zeros(len(X), np.int64)
    assert tc.calinski_harabasz_score(X, a, 1, device="cpu") == 0.0
    assert tc.calinski_harabasz_score(X, a, len(X), device="cpu") == 0.0


def test_bounds_and_intrinsic_dimension(data):
    _, X = data
    for seed in (0, SEED):
        assert tc.estimate_intrinsic_dimension(X, seed, device="cpu") == jc.estimate_intrinsic_dimension(X, seed)
        assert tc.step1_bounds(X, seed, device="cpu") == jc.step1_bounds(X, seed)
    assert tc.estimate_intrinsic_dimension(X[:9], device="cpu") == jc.estimate_intrinsic_dimension(X[:9])


def test_step2_and_pilot_radius(data):
    name, X = data
    k_min, k_max, _ = jc.step1_bounds(X, SEED)
    k = jc.step2_calinski_harabasz(X, k_min, k_max, SEED)
    assert tc.step2_calinski_harabasz(X, k_min, k_max, SEED, device="cpu") == k
    assert _rel_close(jc.compute_threshold_from_pilot(X, k, SEED),
                      tc.compute_threshold_from_pilot(X, k, SEED, device="cpu"))


def test_step2_coarse_and_fine_sweep():
    """A range wider than 15 takes steps of 3, then the fine pass."""
    X = make_gaussian_cliques_multi(300, 0.5, 5, 10, seed=9).astype(np.float32)[:150]
    assert tc.step2_calinski_harabasz(X, 4, 20, SEED, device="cpu") == jc.step2_calinski_harabasz(X, 4, 20, SEED)
    assert tc.step2_calinski_harabasz(X[:9], 2, 5, device="cpu") == 2


def test_compute_optimal_k_equal(data):
    _, X = data
    rk, rr, rid = jc.compute_optimal_k(X, SEED)
    gk, gr, gid = tc.compute_optimal_k(X, SEED, device="cpu")
    assert (gk, gid) == (rk, rid) and _rel_close(rr, gr)
    # A tensor gives the same answer on its device.
    assert tc.compute_optimal_k(torch.from_numpy(X), SEED) == (gk, gr, gid)


def test_builder_default_k_matches_reference():
    X = make_gaussian_cliques_multi(300, 0.5, 5, 10, seed=9).astype(np.float32)

    def conf(b):
        return b.with_lambda_graph(1.0, 6).with_sparsity_check(False).with_seed(SEED)

    ja, jgl = conf(jbuilder.ArrowSpaceBuilder()).build(X)
    tb = conf(tbuilder.ArrowSpaceBuilder(device="cpu"))
    ta, tgl = tb.build(X)
    assert ta.n_clusters == ja.n_clusters and _rel_close(ja.cluster_radius, ta.cluster_radius)
    assert tb.cluster_max_clusters == ja.n_clusters
    assert np.array_equal(ta.cluster_assignments, ja.cluster_assignments)
    assert np.allclose(np.asarray(ja.lambdas), ta.lambdas.numpy(), atol=1e-5)
    # A user radius stays beside the heuristic k.
    tb2 = conf(tbuilder.ArrowSpaceBuilder(device="cpu")).with_cluster_params(radius=77.0)
    ta2, _ = tb2.build(X)
    assert ta2.cluster_radius == 77.0 and tb2.cluster_max_clusters == ta.n_clusters
    with pytest.raises(ValueError, match="clustering_seed"):
        tbuilder.ArrowSpaceBuilder(device="cpu").build(X)


@pytest.mark.parametrize("sampling", [None, "simple", "density_adaptive"])
def test_incremental_batched_matches_reference(sampling):
    """The batched path (no native scan, ``deterministic=False``) on the
    same inputs and sampler seeds."""
    X = make_gaussian_blob(5000, 0.4).astype(np.float32)

    def sampler():
        return None if sampling is None else make_sampler(sampling, 0.7, seed=4)

    from matternet_rs_tpu.sampling import make_sampler as jmake

    ref = jc._incremental_batched(X, 40, 2.0, None if sampling is None else jmake(sampling, 0.7, seed=4), 512)
    got = tc._incremental_batched(X, 40, 2.0, sampler(), 512, device="cpu")
    assert np.array_equal(ref.assignments, got.assignments)
    assert np.array_equal(ref.sizes, got.sizes)
    assert np.allclose(ref.centroids, got.centroids, atol=1e-5)


def test_incremental_clustering_routes_like_reference(monkeypatch):
    """Without the native scan: sequential when deterministic or within one
    batch, batched otherwise — and the same results as the reference's
    routes."""
    from matternet_rs_tpu import native as jnative
    from matternet_rs_tpu_torch import native as tnative

    monkeypatch.setattr(tnative, "incremental_cluster", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "incremental_cluster", lambda *a, **k: None)
    X = make_gaussian_blob(3000, 0.4).astype(np.float32)
    for det in (True, False):
        ref = jc.incremental_clustering(X, 30, 2.0, deterministic=det, batch_size=1024)
        got = tc.incremental_clustering(X, 30, 2.0, deterministic=det, batch_size=1024, device="cpu")
        assert np.array_equal(ref.assignments, got.assignments), det
        assert np.allclose(ref.centroids, got.centroids, atol=1e-5), det


def test_nearest_centroid():
    C = np.array([[0.0, 0.0], [3.0, 4.0]], np.float32)
    assert tc.nearest_centroid(np.array([2.5, 4.0]), C) == jc.nearest_centroid(np.array([2.5, 4.0]), C)
