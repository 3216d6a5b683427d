"""Port vs reference: the IVF-pruned search (``index/ivf.py`` and the
``ArrowSpace`` methods over it), the cases of ``tests/test_ivf.py`` run on
both packages with the same numpy inputs (JAX-CPU against torch-CPU).

Each case checks its property on the port and holds the port's layout and
results against the reference's: bucket items and owners equal; the λ
intervals within 1e-5 (each package's own normalised λ, which agree within
that); centroids within 1e-6 absolute (float64 segment means cast to
float32: equal here); search ids equal and scores within 1e-5.
"""

import numpy as np
import pytest

from matternet_rs_tpu.builder import ArrowSpaceBuilder as JBuilder
from matternet_rs_tpu.index import ivf as jivf

from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder as TBuilder
from matternet_rs_tpu_torch.index import ivf as tivf
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

CPU = "cpu"
TOL = 1e-5


def _configure(b):
    return (b.with_lambda_graph(1.0, 6).with_sparsity_check(False)
            .with_cluster_params(max_clusters=24, radius=20.0).with_sampling(None))


@pytest.fixture(scope="module")
def built():
    data = make_energy_test_dataset(2000, 32, seed=9).astype(np.float32)
    ja, jgl = _configure(JBuilder()).build(data)
    ta, tgl = _configure(TBuilder(device=CPU)).build(data)
    ja.build_ivf_index(bucket_size=64)
    ta.build_ivf_index(bucket_size=64)
    return data, ja, jgl, ta, tgl


def _same_layout(jv, tv, lambdas=None):
    """Equal layouts; with ``lambdas`` (the port's λ) two items may trade
    places inside a cluster's λ order only where their λ agree within 1e-5
    (each package sorts by its own λ)."""
    assert tv.n_clusters == jv.n_clusters and tv.n_buckets == jv.n_buckets
    assert tv.bucket_size == jv.bucket_size and tv.n_items == jv.n_items
    got, ref = tv.bucket_items.numpy(), np.asarray(jv.bucket_items)
    if lambdas is None:
        np.testing.assert_array_equal(got, ref)
    else:
        diff = got != ref
        assert (got[diff] >= 0).all() and (ref[diff] >= 0).all()
        assert np.all(np.abs(lambdas[got[diff]] - lambdas[ref[diff]]) < TOL), (got[diff], ref[diff])
    np.testing.assert_array_equal(tv.bucket_centroid.numpy(), np.asarray(jv.bucket_centroid))
    # The intervals hold each package's own λ, which agree within 1e-5.
    np.testing.assert_allclose(tv.bucket_lambda_lo.numpy(), np.asarray(jv.bucket_lambda_lo),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tv.bucket_lambda_hi.numpy(), np.asarray(jv.bucket_lambda_hi),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tv.centroids.numpy(), np.asarray(jv.centroids), atol=1e-6, rtol=0)


def _same_results(ref, got):
    assert [i for i, _ in got] == [i for i, _ in ref]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], atol=TOL, rtol=0)


def test_layout_every_item_exactly_once(built):
    data, ja, _, ta, _ = built
    items = ta.ivf.bucket_items.numpy().ravel()
    real = items[items >= 0]
    assert len(real) == data.shape[0] and len(np.unique(real)) == data.shape[0]
    _same_layout(ja.ivf, ta.ivf)


def test_layout_bucket_owners_valid(built):
    _, ja, _, ta, _ = built
    owners = ta.ivf.bucket_centroid.numpy()
    assert owners.min() >= 0 and owners.max() < ta.ivf.n_clusters
    cents, bi, X = ta.ivf.centroids.numpy(), ta.ivf.bucket_items.numpy(), ta.data.numpy()
    for b in range(min(5, bi.shape[0])):
        members = bi[b][bi[b] >= 0]
        d = ((X[members][:, None, :] - cents[None, :, :]) ** 2).sum(-1)
        assert (d.argmin(1) == owners[b]).all()
    np.testing.assert_array_equal(owners, np.asarray(ja.ivf.bucket_centroid))


def test_outlier_items_reachable():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 8)).astype(np.float32)
    a = rng.integers(0, 4, 300)
    a[:40] = -1
    tv = tivf.build_ivf(X, assignments=a, bucket_size=32, device=CPU)
    items = tv.bucket_items.numpy().ravel()
    assert len(items[items >= 0]) == 300
    _same_layout(jivf.build_ivf(X, assignments=a, bucket_size=32), tv)


def test_full_probe_equals_exact_scan(built):
    data, ja, jgl, ta, tgl = built
    q = data[17]
    ql = ta.prepare_query_item(q, tgl)
    exact = ta.search_lambda_aware(q, ql, 10)
    pruned = ta.search_lambda_aware_ivf(q, ql, 10, nprobe=ta.ivf.n_buckets)
    assert [i for i, _ in exact] == [i for i, _ in pruned]
    np.testing.assert_allclose([s for _, s in exact], [s for _, s in pruned], rtol=1e-5)
    jql = ja.prepare_query_item(q, jgl)
    _same_results(ja.search_lambda_aware_ivf(q, jql, 10, nprobe=ja.ivf.n_buckets), pruned)


def test_recall_at_moderate_nprobe(built):
    data, ja, jgl, ta, tgl = built
    rng = np.random.default_rng(3)
    hits = total = 0
    for i in rng.integers(0, data.shape[0], 32):
        q = data[i] + rng.normal(0, 0.05, data.shape[1]).astype(np.float32)
        ql = ta.prepare_query_item(q, tgl)
        exact = {j for j, _ in ta.search_lambda_aware(q, ql, 10)}
        got = ta.search_lambda_aware_ivf(q, ql, 10, nprobe=8)
        hits += len(exact & {j for j, _ in got})
        total += len(exact)
        _same_results(ja.search_lambda_aware_ivf(q, ja.prepare_query_item(q, jgl), 10, nprobe=8),
                      got)
    assert hits / total >= 0.85, f"recall {hits / total:.3f} too low at nprobe=8"


def test_self_query_top1(built):
    data, ja, jgl, ta, tgl = built
    q = data[42]
    res = ta.search_lambda_aware_ivf(q, ta.prepare_query_item(q, tgl), 5, nprobe=4)
    assert res[0][0] == 42
    _same_results(ja.search_lambda_aware_ivf(q, ja.prepare_query_item(q, jgl), 5, nprobe=4), res)


@pytest.mark.parametrize("gather_elems", [tivf.GATHER_ELEMS, 3 * 8 * 64 * 32])
def test_batched_matches_serial(built, gather_elems, monkeypatch):
    """Also in query blocks of three (the gather cap cut to 3 queries)."""
    data, ja, jgl, ta, tgl = built
    monkeypatch.setattr(tivf, "GATHER_ELEMS", gather_elems)
    qidx = np.random.default_rng(5).integers(0, data.shape[0], 8)
    Q = data[qidx]
    bidx, bsc = ta.search_batch_ivf(Q, tgl, 10, nprobe=8)
    for r, i in enumerate(qidx):
        serial = ta.search_lambda_aware_ivf(data[i], ta.prepare_query_item(data[i], tgl), 10,
                                            nprobe=8)
        assert bidx[r].tolist()[:len(serial)] == [j for j, _ in serial]
    jidx, jsc = ja.search_batch_ivf(Q, jgl, 10, nprobe=8)
    np.testing.assert_array_equal(bidx, np.asarray(jidx))
    np.testing.assert_allclose(bsc, np.asarray(jsc), atol=TOL, rtol=0)


def test_gather_blocks_stay_under_the_cap():
    assert tivf.gather_block_queries(8 * 1024, 128) == (1 << 28) // (8 * 1024 * 128)
    assert tivf.gather_block_queries(1 << 30, 128) == 1
    assert tivf.gather_block_queries(64, 32, gather_elems=3 * 64 * 32) == 3


def test_deterministic(built):
    data, ja, jgl, ta, tgl = built
    q = data[100]
    ql = ta.prepare_query_item(q, tgl)
    a = ta.search_lambda_aware_ivf(q, ql, 10, nprobe=6)
    assert a == ta.search_lambda_aware_ivf(q, ql, 10, nprobe=6)
    _same_results(ja.search_lambda_aware_ivf(q, ja.prepare_query_item(q, jgl), 10, nprobe=6), a)


def test_kmeans_fallback_without_assignments():
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(5, 16)) * 4
    X = (centers[rng.integers(0, 5, 500)] + rng.normal(size=(500, 16))).astype(np.float32)
    tv = tivf.build_ivf(X, n_clusters=5, bucket_size=128, device=CPU)
    assert tv.n_clusters == 5
    items = tv.bucket_items.numpy().ravel()
    assert len(items[items >= 0]) == 500
    _same_layout(jivf.build_ivf(X, n_clusters=5, bucket_size=128), tv)


def test_skewed_cluster_spans_buckets():
    rng = np.random.default_rng(2)
    X = np.concatenate([rng.normal(0, 0.1, (900, 8)), rng.normal(10, 0.1, (30, 8))]).astype(np.float32)
    a = np.concatenate([np.zeros(900, int), np.ones(30, int)])
    tv = tivf.build_ivf(X, assignments=a, bucket_size=100, device=CPU)
    owners = tv.bucket_centroid.numpy()
    assert (owners == 0).sum() == 9 and (owners == 1).sum() == 1
    _same_layout(jivf.build_ivf(X, assignments=a, bucket_size=100), tv)


def test_segment_means_sum_as_add_at():
    """The sorted ``reduceat`` sums each cluster's rows in row order, as
    the reference's ``np.add.at``: the means are equal bit for bit."""
    rng = np.random.default_rng(4)
    X = (rng.normal(size=(700, 12)) * 10).astype(np.float32)
    a = rng.integers(-1, 9, 700)
    a[a == 4] = 5
    valid = a >= 0
    sums = np.zeros((9, 12))
    np.add.at(sums, a[valid], X[valid])
    counts = np.bincount(a[valid], minlength=9).astype(np.float64)
    keep = counts > 0
    ref = (sums[keep] / counts[keep, None]).astype(np.float32)
    np.testing.assert_array_equal(tivf._segment_means(X, a), ref)


def test_add_items_rebuilds_the_layout(built):
    """Rows appended after the build (assignments cover a prefix) land in
    buckets in both packages alike, up to near-equal λ inside a cluster
    (``data[0]`` and the appended ``data[0] + 0.25`` trade places)."""
    data, ja, jgl, ta, tgl = built
    import copy

    new = data[:40] + np.float32(0.25)
    jc, tc = copy.deepcopy(ja), copy.deepcopy(ta)
    jc.add_items(new, jgl)
    tc.add_items(new, tgl)
    items = tc.ivf.bucket_items.numpy().ravel()
    assert len(items[items >= 0]) == data.shape[0] + 40
    _same_layout(jc.ivf, tc.ivf, lambdas=tc.lambdas.numpy())


def test_drop_data_clears_the_layout(built):
    import copy

    _, _, _, ta, _ = built
    tc = copy.deepcopy(ta)
    tc.drop_data()
    assert tc.ivf is None
    with pytest.raises(ValueError, match="build_ivf_index"):
        tc.search_lambda_aware_ivf(np.ones(32, np.float32), 0.5, 5)
    assert ta.ivf is not None


def _module_form_input():
    """3,000 × 16 normal rows, uniform λ, 12 clusters, buckets of 64."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3000, 16)).astype(np.float32)
    lam = rng.uniform(size=3000).astype(np.float32)
    a = rng.integers(0, 12, 3000)
    norms = np.linalg.norm(X, axis=1).astype(np.float32)
    jv = jivf.build_ivf(X, assignments=a, bucket_size=64, lambdas=lam)
    tv = tivf.build_ivf(X, assignments=a, bucket_size=64, lambdas=lam, device=CPU)
    return X, lam, norms, jv, tv


def _six(v):
    return (v.centroids, v.centroid_norms, v.bucket_items, v.bucket_centroid,
            v.bucket_lambda_lo, v.bucket_lambda_hi)


def test_module_search_takes_the_reference_arguments():
    """``ivf_search`` called as the reference is called: fourteen
    positional arguments, the six layout arrays first."""
    import jax.numpy as jnp
    import torch

    X, lam, norms, jv, tv = _module_form_input()
    ji, js = jivf.ivf_search(*_six(jv), jnp.asarray(X), jnp.asarray(norms), jnp.asarray(lam),
                             jnp.asarray(X[5]), lam[5], 10, 0.7, 4)
    t = torch.from_numpy
    ti, ts = tivf.ivf_search(*_six(tv), t(X), t(norms), t(lam), t(X[5]), lam[5], 10, 0.7, 4)
    want = [5, 1548, 88, 1561, 82, 887, 483, 2597, 95, 1208]
    assert np.asarray(ji).tolist() == want
    assert ti.tolist() == want
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=TOL, rtol=0)


def test_module_batch_search_takes_the_reference_arguments():
    import jax.numpy as jnp
    import torch

    X, lam, norms, jv, tv = _module_form_input()
    rows = np.array([5, 17, 640, 1999, 2999])
    ji, js = jivf.ivf_search_batch(*_six(jv), jnp.asarray(X), jnp.asarray(norms),
                                   jnp.asarray(lam), jnp.asarray(X[rows]),
                                   jnp.asarray(lam[rows]), 10, 0.7, 4)
    t = torch.from_numpy
    ti, ts = tivf.ivf_search_batch(*_six(tv), t(X), t(norms), t(lam), t(X[rows]),
                                   t(lam[rows]), 10, 0.7, 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0].tolist() == [5, 1548, 88, 1561, 82, 887, 483, 2597, 95, 1208]
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=TOL, rtol=0)
    one = [tivf.ivf_search(*_six(tv), t(X), t(norms), t(lam), t(X[r]), lam[r], 10, 0.7, 4)[0]
           for r in rows]
    assert ti.tolist() == [o.tolist() for o in one]
