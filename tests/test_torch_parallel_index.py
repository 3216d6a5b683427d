"""Port vs reference: ``ShardedArrowSpace`` — the distributed builds, the
searches on every sharded tier, query λ, and stores written by either
package and loaded by the other.

The reference runs on its 8 CPU devices, the port on 8 CPU slots (and
both on 2 × 4 meshes). The data has separated clusters, so Lloyd's
assignments do not flip at near ties (ROADMAP Queue 3).

Tolerances: λ within 1e-5·max(|λ|, 1) and the λ stats within 1e-5
relative (XLA and PyTorch sum the seven products in different orders);
centroids within 1e-4; searches on one index (the reference's, carried
across with ``convert``) agree under the same-k near-tie rule at 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu.graph import GraphParams as JGraphParams
from matternet_rs_tpu.index import streaming as jst
from matternet_rs_tpu.parallel import clustering as jpc
from matternet_rs_tpu.parallel import mesh as jmesh
from matternet_rs_tpu.parallel.index import ShardedArrowSpace as JSA

from matternet_rs_tpu_torch import ArrowSpace, convert
from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.index import streaming as tst
from matternet_rs_tpu_torch.parallel import clustering as tpc
from matternet_rs_tpu_torch.parallel import mesh as tmesh
from matternet_rs_tpu_torch.parallel.index import ShardedArrowSpace as TSA
from matternet_rs_tpu_torch.utils.parity import same_k_mismatches

CPU = torch.device("cpu")
N, F, K = 1203, 16, 10
TOL_LAM = 1e-5


def _meshes(kind):
    if kind == "1d":
        return jmesh.make_mesh(8), tmesh.make_mesh(8, devices=[CPU] * 8)
    return jmesh.make_mesh_2d(2, 4), tmesh.make_mesh_2d(2, 4, devices=[CPU] * 8)


def _clustered(n, f, seed, centres=6):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centres, f)) * 4.0
    return (c[rng.integers(0, centres, n)] + rng.normal(size=(n, f))).astype(np.float32)


DATA = _clustered(N, F, seed=29)
BLOCKS = [DATA[:500], DATA[500:1100], DATA[1100:]]


def _params(mod):
    return mod(eps=1.0, k=6, topk=6, sparsity_check=False)


def _lam_close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.all(np.abs(got - ref) <= TOL_LAM * np.maximum(np.abs(ref), 1.0))


def _carried(sa, tm):
    """The reference's sharded index as the port's, on ``tm``."""
    return convert.sharded_arrowspace_from_arrays(
        tm, np.asarray(sa.X), np.asarray(sa.norms), np.asarray(sa.lambdas),
        np.asarray(sa.gl.matrix), n_items=sa.n_items, min_lambdas=sa.min_lambdas,
        range_lambdas=sa.range_lambdas, mesh_shape=sa.mesh.devices.shape,
        tau_mode=(sa.taumode.mode, sa.taumode.param))


@pytest.fixture(scope="module", params=["1d", "2d"])
def built(request):
    jm, tm = _meshes(request.param)
    kw = dict(k_clusters=12, radius=6.0)
    js = JSA.distributed_build(BLOCKS, _params(JGraphParams), mesh=jm, **kw)
    ts = TSA.distributed_build(BLOCKS, _params(GraphParams), mesh=tm, **kw)
    return js, ts, _carried(js, tm)


def test_serial_build_lambda_and_stats(built):
    js, ts, _ = built
    assert ts.n_items == js.n_items == N
    assert ts.X.shape == js.X.shape
    np.testing.assert_allclose(ts.gl.matrix.numpy(), np.asarray(js.gl.matrix), atol=1e-6)
    _lam_close(ts.lambdas.gather().numpy()[:N], np.asarray(js.lambdas)[:N])
    assert ts.min_lambdas == pytest.approx(js.min_lambdas, rel=TOL_LAM, abs=1e-7)
    assert ts.range_lambdas == pytest.approx(js.range_lambdas, rel=TOL_LAM)
    np.testing.assert_allclose(ts.norms.gather().numpy(), np.asarray(js.norms), rtol=1e-6)


def test_lloyd_matches_reference():
    jm, tm = _meshes("1d")
    jX = jmesh.shard_items_from_blocks(jm, BLOCKS)
    tX = tmesh.shard_items_from_blocks(tm, BLOCKS)
    jc, jn, ja = jpc.distributed_lloyd(jm, jX, N, 6, iters=8)
    tc, tn, ta = tpc.distributed_lloyd(tm, tX, N, 6, iters=8)
    np.testing.assert_allclose(tc, jc, atol=1e-4)
    assert np.array_equal(tn, np.asarray(jn))
    assert np.array_equal(ta.gather().numpy(), np.asarray(ja))
    assert np.all(ta.gather().numpy()[N:] == -1)
    js = JSA.distributed_build(BLOCKS, _params(JGraphParams), k_clusters=6, mesh=jm,
                               centroids="lloyd", lloyd_iters=8)
    ts = TSA.distributed_build(BLOCKS, _params(GraphParams), k_clusters=6, mesh=tm,
                               centroids="lloyd", lloyd_iters=8)
    _lam_close(ts.lambdas.gather().numpy()[:N], np.asarray(js.lambdas)[:N])


def test_build_options_are_checked():
    tm = tmesh.make_mesh(2, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="'lloyd' or 'serial'"):
        TSA.distributed_build(BLOCKS, _params(GraphParams), 4, mesh=tm, centroids="kmeans")
    with pytest.raises(ValueError, match="at least one sample row"):
        TSA.distributed_build(BLOCKS, _params(GraphParams), 4, mesh=tm, centroid_sample=0)


def test_from_shards_equals_the_single_card_index(built):
    """The mesh index equals the port's single-card index of the same rows
    and graph (the λ route of the whole corpus in every slot)."""
    _, ts, _ = built
    sa = TSA.from_shards(BLOCKS, ts.gl, mesh=ts.mesh)
    one = ArrowSpace.from_items(DATA, device=CPU)
    one.compute_taumode(ts.gl)
    np.testing.assert_allclose(sa.lambdas.gather().numpy()[:N], one.lambdas.numpy(), atol=1e-6)
    assert sa.min_lambdas == pytest.approx(one.min_lambdas, abs=1e-7)
    assert sa.range_lambdas == pytest.approx(one.range_lambdas, rel=1e-6)
    with pytest.raises(ValueError, match="feature dim"):
        TSA.from_shards([DATA[:, :8]], ts.gl, mesh=ts.mesh)
    full = TSA.from_arrowspace(one, ts.gl, mesh=ts.mesh)
    assert torch.equal(full.lambdas.gather()[:N], one.lambdas)
    ri, rs = one.search_batch(DATA[:5], ts.gl, K)
    gi, gs = full.search_batch(DATA[:5], K)
    assert np.array_equal(gi, ri)
    np.testing.assert_allclose(gs, rs, rtol=1e-6)


def test_query_lambdas(built):
    js, _, tc = built
    Q = DATA[::97]
    np.testing.assert_allclose(tc.prepare_query_lambdas_batch(Q).numpy(),
                               np.asarray(js.prepare_query_lambdas_batch(Q)), atol=1e-6)
    assert tc.prepare_query_lambda(Q[0]) == pytest.approx(js.prepare_query_lambda(Q[0]), abs=1e-6)
    with pytest.raises(ValueError, match="Query dimension"):
        tc.prepare_query_lambdas_batch(Q[:, :5])


def test_energy_query_lambdas_take_the_nearest_sub_centroid():
    jm, tm = _meshes("1d")
    rng = np.random.default_rng(2)
    sub = rng.normal(size=(9, F)).astype(np.float32)
    sub_lam = rng.random(9).astype(np.float32)
    js = JSA.from_shards(BLOCKS, _graph(), mesh=jm)
    js.sub_centroids, js.subcentroid_lambdas = jnp.asarray(sub), sub_lam
    tc = convert.sharded_arrowspace_from_arrays(
        tm, np.asarray(js.X), np.asarray(js.norms), np.asarray(js.lambdas),
        np.asarray(js.gl.matrix), n_items=N, min_lambdas=js.min_lambdas,
        range_lambdas=js.range_lambdas, sub_centroids=sub, subcentroid_lambdas=sub_lam)
    Q = DATA[::50]
    assert np.array_equal(tc.prepare_query_lambdas_batch(Q).numpy(),
                          np.asarray(js.prepare_query_lambdas_batch(Q)))


def _graph():
    from matternet_rs_tpu.ops import laplacian as jlap

    return jlap.build_laplacian_from_k_cluster(jnp.asarray(DATA[::100]), _params(JGraphParams),
                                               n_items=N)


def _same(ref, got, tol=1e-6):
    """Scores position by position within ``tol``; an id may differ only
    where the two scores there agree within ``tol`` (the same-k near-tie
    rule: XLA and PyTorch sum a dot in different orders, ≈ 1e-7 here, and
    the clustered rows tie that closely at k = 200)."""
    ref_i, ref_s = np.atleast_2d(ref[0]), np.atleast_2d(np.asarray(ref[1], np.float64))
    got_i, got_s = np.atleast_2d(got[0]), np.atleast_2d(np.asarray(got[1], np.float64))
    assert got_i.shape == ref_i.shape
    assert not same_k_mismatches(ref_i, ref_s, got_i, got_s, tol)
    assert np.mean(got_i == ref_i) > 0.9


def _pairs(res):
    return [i for i, _ in res], [s for _, s in res]


@pytest.mark.parametrize("quantized", [False, "int8", "int8_rescored", "bf16x3_rescored",
                                       "auto", "int8_auto"])
@pytest.mark.parametrize("b", [5, 16])
def test_search_batch_every_tier(built, quantized, b):
    js, _, tc = built
    Q = DATA[np.random.default_rng(b).choice(N, b, replace=False)] + 0.05
    # Per-query alphas on the quantised tiers (the reference's exact tier
    # takes a scalar only).
    al = 0.6 if b == 5 or quantized is False else np.linspace(0.3, 0.9, b).astype(np.float32)
    kw = {} if quantized is False else dict(quantized=quantized)
    if quantized is not False:
        kw["candidates"] = 40
    _same(js.search_batch(Q, K, al, **kw), tc.search_batch(Q, K, al, **kw))


def test_search_batch_rejects_unoffered_tiers(built):
    _, _, tc = built
    for tier in ("bf16_rescored", True, "int4"):
        with pytest.raises(ValueError, match="not supported"):
            tc.search_batch(DATA[:2], K, quantized=tier)


@pytest.mark.parametrize("k", [1, 10, 200])
def test_single_hybrid_and_energy_searches(built, k):
    """On one query λ (the reference's: the two query λ agree within 1e-6,
    ``test_query_lambdas``, which would reorder near ties at k = 200)."""
    js, _, tc = built
    for row in (7, 600, 1202):
        q = DATA[row] + 0.01
        ql = js.prepare_query_lambda(q)
        _same(_pairs(js.search(q, k, query_lambda=ql)), _pairs(tc.search(q, k, query_lambda=ql)))
        _same(_pairs(js.search_hybrid(q, k, query_lambda=ql)),
              _pairs(tc.search_hybrid(q, k, query_lambda=ql)))
        ref = js.search_energy(q, k, query_lambda=ql)
        got = tc.search_energy(q, k, query_lambda=ql)
        assert [i for i, _ in got] == [i for i, _ in ref]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("eps", [-0.2, 0.0, 0.05])
def test_range_search(built, eps):
    js, _, tc = built
    q = DATA[33]
    ref, got = js.range_search(q, eps), tc.range_search(q, eps)
    assert [i for i, _ in got] == [i for i, _ in ref]
    np.testing.assert_allclose([d for _, d in got], [d for _, d in ref], atol=1e-6)
    assert all(i < N for i, _ in got)


def test_stores_cross_load(tmp_path, built):
    """A store written by either package's sharded index loads in the
    other (``load_from_store``) and in both streaming indexes."""
    js, ts, _ = built
    jdir, tdir = tmp_path / "from_jax", tmp_path / "from_torch"
    js.to_store(jdir)
    ts.to_store(tdir)
    q = DATA[44]
    t_from_j = TSA.load_from_store(jdir, mesh=ts.mesh)
    j_from_t = JSA.load_from_store(tdir, mesh=js.mesh)
    assert t_from_j.n_items == j_from_t.n_items == N
    _same(_pairs(js.search(q, K)), _pairs(t_from_j.search(q, K)))
    _same(_pairs(j_from_t.search(q, K)), _pairs(ts.search(q, K)), tol=1e-5)
    np.testing.assert_allclose(t_from_j.lambdas.gather().numpy()[:N],
                               np.asarray(js.lambdas)[:N], atol=1e-6)
    for d in (jdir, tdir):
        ri, rs = jst.StreamingIndex.load(d).search_batch(q[None], K)
        gi, gs = tst.StreamingIndex.load(d, device=CPU).search_batch(q[None], K)
        assert np.array_equal(gi, np.asarray(ri))
        np.testing.assert_allclose(gs, np.asarray(rs), rtol=1e-5)


def test_to_store_needs_every_slot(tmp_path, built):
    _, ts, _ = built
    half = tmesh.ShardedArray(ts.mesh, [None] + ts.X.shards[1:], ts.X.shape)
    from matternet_rs_tpu_torch.parallel import index as tpi

    with pytest.raises(RuntimeError, match="do not span the corpus"):
        list(tpi._device_blocks(half, N))
