"""The port's streaming index (``matternet_rs_tpu_torch/index/streaming.py``)
against the reference's, on the same shard stores and the same queries, on
the CPU. The reference's maxima-first scan runs its Pallas kernels in
interpret mode (with its TPU-platform gate replaced, as its own tests do);
the port runs kernels D and E through their plain versions.

Tolerances:
* λ: |Δ| ≤ 1e-5·max(|λ|, 1) (the closed form summed in another order);
  the graph ≤ 1e-6 absolute (the Laplacian tests' tolerance), the stored
  min/range within 1e-5 relative;
* exact and bf16 streamed scans: ids under the near-tie rule
  (``utils/parity``) at 1e-5, scores within 2e-6 (f32 summation order);
* sketch scans: products of int8 rows and bf16 queries are exact in f32, so
  only the order of summation differs: each score within
  2·F·2⁻²⁴·α·mult·Σ|q_bf16||x8|/‖q‖ of the reference's, plus 1e-6 for the
  blend's rounding (``_sketch_bound``), ids under the same-k rule at that
  bound;
* refined results: ids equal, scores within 2e-6;
* the sketch files and the quantiser bit for bit.
"""

import functools
import json
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu.graph import GraphParams as JGraphParams
from matternet_rs_tpu.index import streaming as jst
from matternet_rs_tpu.storage import shards as jshards
from matternet_rs_tpu.utils.fixtures import make_energy_test_dataset

from matternet_rs_tpu_torch.graph import GraphParams as TGraphParams
from matternet_rs_tpu_torch.index import streaming as tst
from matternet_rs_tpu_torch.storage import shards as tshards
from matternet_rs_tpu_torch.utils.parity import (
    energy_store_tolerance,
    same_k_mismatches,
    topk_mismatches,
)

K = 10
TOL_LAM = 1e-5
TOL_SCORE = 2e-6
CPU = "cpu"


def _params(mod):
    return mod(eps=1.0, k=6, topk=6, sparsity_check=False)


def _clustered(n, f, seed, centres=8):
    """Gaussian centres × 4 plus unit noise (the maxima-first fixture's data)."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centres, f)) * 4.0
    return (c[rng.integers(0, centres, n)] + rng.normal(size=(n, f))).astype(np.float32)


def _build_pair(tmp, data, block_rows, rows_per_shard, emit_sketch=True, max_clusters=16,
                sample_rows=4096):
    """The same shards in two directories, built by each package."""
    dj, dt = tmp / "jax", tmp / "torch"
    jshards.write_shards(data, dj, rows_per_shard=rows_per_shard)
    tshards.write_shards(data, dt, rows_per_shard=rows_per_shard)
    kw = dict(max_clusters=max_clusters, radius=20.0, block_rows=block_rows,
              sample_rows=sample_rows, emit_sketch=emit_sketch)
    ji = jst.StreamingIndex.build_from_store(dj, _params(JGraphParams), **kw)
    ti = tst.StreamingIndex.build_from_store(dt, _params(TGraphParams), device=CPU, **kw)
    return ji, ti


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """34,000 × 32 in 4,096-row blocks: nb = 9, flat 36,864 rows = 18
    tiles of 2,048, suffix-padded (the reference's maxima-first fixture)."""
    data = _clustered(34_000, 32, seed=19)
    ji, ti = _build_pair(tmp_path_factory.mktemp("stream_pair"), data, 4096, 9000)
    ji.build_sketch(persist=False)
    ti.build_sketch(persist=False)
    return ji, ti, data


@pytest.fixture
def reference_maxfirst_interpret(monkeypatch):
    """The reference's maxima-first kernels in interpret mode and its
    TPU-platform gate replaced by the shape envelope (its own tests' way)."""
    from matternet_rs_tpu.ops.pallas import tilemax_fused as tmf

    monkeypatch.setattr(tmf, "tilemax_only", functools.partial(tmf.tilemax_only, interpret=True))
    monkeypatch.setattr(tmf, "slab_dots_ring", functools.partial(tmf.slab_dots_ring, interpret=True))

    def cpu_supported(nn, ff, bb, tile, subs=tmf.SUBS):
        return (nn >= tile and ff <= tmf.MAX_FUSED_F_WIDE
                and tmf.MIN_FUSED_B <= bb <= tmf.MAX_FUSED_B and tile % (subs * 128) == 0)

    monkeypatch.setattr(tmf, "tilemax_only_supported", cpu_supported)


def _queries(data, b, seed):
    return data[np.random.default_rng(seed).choice(len(data), b, replace=False)]


# ----------------------------------------------------------- host helpers
@pytest.mark.parametrize("case", ["normal", "zero_rows", "wide_range", "constant", "one_hot"])
def test_quantize_rows_bit_for_bit(case):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(257, 24)).astype(np.float32)
    if case == "zero_rows":
        x[::5] = 0.0
    elif case == "wide_range":
        x *= np.logspace(-20, 20, 257, dtype=np.float32)[:, None]
    elif case == "constant":
        x[:] = -0.5
    elif case == "one_hot":
        x = np.eye(24, dtype=np.float32)[rng.integers(0, 24, 257)] * 3.0
    q_ref, m_ref = jst._quantize_rows(x)
    q, m = tst._quantize_rows(x)
    assert q.dtype == np.int8 and m.dtype == np.float32
    assert np.array_equal(q, q_ref)
    assert np.array_equal(m.view(np.int32), m_ref.view(np.int32))
    if case == "zero_rows":
        assert np.all(m[::5] == 0.0) and np.all(q[::5] == 0)


@pytest.mark.parametrize("case", ["normal", "zeros", "ties", "extremes", "subnormal"])
def test_host_bf16_bits_equal_ml_dtypes(case):
    """torch's f32 → bf16 rounds to nearest even, as ``ml_dtypes`` does."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 33)).astype(np.float32)
    if case == "zeros":
        x[::3] = 0.0
        x[1::3] = -0.0
    elif case == "ties":                     # mantissas exactly halfway between two bf16
        bits = (rng.integers(0, 1 << 16, size=x.shape).astype(np.uint32) << 16) | 0x8000
        x = bits.view(np.float32)
        x = np.where(np.isfinite(x), x, 1.0).astype(np.float32)
    elif case == "extremes":
        x[0] = np.float32(3.4e38)
        x[1] = -np.float32(3.4e38)
        x[2] = np.inf
        x[3] = -np.inf
    elif case == "subnormal":
        x *= np.float32(1e-39)
    ref = np.asarray(jst._host_bf16(x)).view(np.uint16)
    got = tst._host_bf16(x).view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("valid,blk", [
    ([4, 4, 4, 2], 4), ([4, 4, 2, 0, 0], 4), ([4, 2, 4], 4), ([4, 0, 1], 4),
    ([4, 4, 4], 4), ([0, 0], 4), ([3], 4), ([4, 4, 0, 4], 4),
])
def test_suffix_padded_matches_reference(valid, blk):
    assert tst.suffix_padded(np.asarray(valid), blk) == jst.suffix_padded(np.asarray(valid), blk)


# ----------------------------------------------------------- build and store
def _index_json(d):
    return json.loads((d / tst.INDEX_FILE).read_text())


def _assert_same_store(dj, dt):
    mj, mt = _index_json(dj), _index_json(dt)
    stats = ("min_lambdas", "range_lambdas")
    assert {k: v for k, v in mj.items() if k not in stats} == \
        {k: v for k, v in mt.items() if k not in stats}
    for key in stats:
        assert mt[key] == pytest.approx(mj[key], rel=1e-5)
    gj = np.fromfile(dj / tst.GRAPH_FILE, np.float32)
    gt = np.fromfile(dt / tst.GRAPH_FILE, np.float32)
    np.testing.assert_allclose(gt, gj, atol=1e-6, rtol=0)
    lj = np.fromfile(dj / tst.LAMBDA_FILE, np.float32)
    lt = np.fromfile(dt / tst.LAMBDA_FILE, np.float32)
    assert lj.shape == lt.shape
    assert np.all(np.abs(lt - lj) <= TOL_LAM * np.maximum(np.abs(lj), 1.0))


@pytest.mark.parametrize("n,f,block_rows,rows_per_shard", [
    (2000, 16, 512, 700), (9000, 24, 2048, 3000), (34_000, 32, 4096, 9000),
])
def test_build_from_store_matches_reference(tmp_path, n, f, block_rows, rows_per_shard):
    data = _clustered(n, f, seed=n + f)
    ji, ti = _build_pair(tmp_path, data, block_rows, rows_per_shard)
    _assert_same_store(tmp_path / "jax", tmp_path / "torch")
    assert ti.build_timings["lambda_rows_computed"] == n
    assert (ti.n_items, ti.n_features, ti.block_rows) == (ji.n_items, ji.n_features, ji.block_rows)
    # emit_sketch: the int8 file byte for byte, the multipliers bit for bit.
    assert (tmp_path / "jax" / tst.SKETCH_FILE).read_bytes() == \
        (tmp_path / "torch" / tst.SKETCH_FILE).read_bytes()
    with np.load(tmp_path / "jax" / tst.SKETCH_META_FILE) as zj, \
            np.load(tmp_path / "torch" / tst.SKETCH_META_FILE) as zt:
        assert np.array_equal(zj["mult"].view(np.int32), zt["mult"].view(np.int32))
    assert not (tmp_path / "torch" / (tst.SKETCH_FILE + ".tmp")).exists()


@pytest.mark.parametrize("tear", ["mid_block", "stray_bytes", "block_edge"])
@pytest.mark.parametrize("store_of", ["torch", "jax"])
def test_resume_after_a_torn_lambda_write(tmp_path, tear, store_of):
    """A λ file cut inside a block (or 1-3 bytes past a block edge) resumes
    from the last whole block; the port resumes either package's torn
    store to the bytes of a full build."""
    data = _clustered(5000, 16, seed=2)
    ji, ti = _build_pair(tmp_path, data, 1024, 1500, emit_sketch=False)
    d = tmp_path / store_of
    lam = d / tst.LAMBDA_FILE
    full = lam.read_bytes()
    cut = {"mid_block": 4 * 1024 * 2 + 4 * 100, "stray_bytes": 4 * 1024 * 3 + 3,
           "block_edge": 4 * 1024}[tear]
    lam.write_bytes(full[:cut])
    before = tst.StreamingIndex.load(d, device=CPU)
    assert before.n_items == 5000
    ri = tst.StreamingIndex.build_from_store(d, _params(TGraphParams), max_clusters=16, radius=20.0,
                                             block_rows=1024, sample_rows=4096, resume=True,
                                             device=CPU)
    whole = (cut // 4 // 1024) * 1024
    assert ri.build_timings["lambda_rows_computed"] == 5000 - whole
    got = np.frombuffer(lam.read_bytes(), np.float32)
    ref = np.frombuffer(full, np.float32)
    assert np.array_equal(got[:whole], ref[:whole])
    assert np.all(np.abs(got - ref) <= TOL_LAM * np.maximum(np.abs(ref), 1.0))
    m = _index_json(d)
    assert m["min_lambdas"] == pytest.approx(float(ref.min()), rel=1e-5)


def test_resume_of_a_complete_file_is_a_no_op(tmp_path):
    data = _clustered(3000, 16, seed=4)
    _, ti = _build_pair(tmp_path, data, 1024, 1000, emit_sketch=True)
    d = tmp_path / "torch"
    lam_before = (d / tst.LAMBDA_FILE).read_bytes()
    sketch_before = (d / tst.SKETCH_FILE).read_bytes()
    ri = tst.StreamingIndex.build_from_store(d, _params(TGraphParams), max_clusters=16, radius=20.0,
                                             block_rows=1024, sample_rows=4096, resume=True,
                                             emit_sketch=True, device=CPU)
    assert ri.build_timings["lambda_rows_computed"] == 0
    assert (d / tst.LAMBDA_FILE).read_bytes() == lam_before
    assert (d / tst.SKETCH_FILE).read_bytes() == sketch_before
    assert (ri.min_lambdas, ri.range_lambdas) == (ti.min_lambdas, ti.range_lambdas)
    # A fresh build drops the stale sketch pair.
    tst.StreamingIndex.build_from_store(d, _params(TGraphParams), max_clusters=16, radius=20.0,
                                        block_rows=1024, sample_rows=4096, device=CPU)
    assert not (d / tst.SKETCH_FILE).exists() and not (d / tst.SKETCH_META_FILE).exists()


def _search_both(ji, ti, Q, k):
    a = ji.search_batch(Q, k)
    b = ti.search_batch(Q, k)
    return (np.asarray(a[0]), np.asarray(a[1])), b


def test_each_package_loads_the_other_dense_store(pair):
    ji, ti, data = pair
    Q = _queries(data, 6, seed=1)
    tj = tst.StreamingIndex.load(ji.directory, device=CPU)      # the port on the reference's store
    jt = jst.StreamingIndex.load(ti.directory)                  # the reference on the port's store
    assert tj.n_items == ji.n_items and jt.n_items == ti.n_items
    for ref, got in ((ji, tj), (jt, ti)):
        (ri, rs), (gi, gs) = _search_both(ref, got, Q, K)
        assert np.array_equal(ri, gi)
        np.testing.assert_allclose(gs, rs, atol=TOL_SCORE, rtol=0)


@pytest.mark.parametrize("built_by", ["jax", "torch"])
def test_ell_backed_store_crosses_packages(tmp_path, monkeypatch, built_by):
    """A store built on the direct-ELL graph (forced at 16 nodes, as the
    reference's test forces it) persists ``graph_ell.npz``; the other
    package loads it ELL-backed and searches alike."""
    from matternet_rs_tpu.ops import laplacian as jlap
    from matternet_rs_tpu_torch.ops import laplacian as tlap

    monkeypatch.setattr(jlap, "DIRECT_ELL_N", 16)
    monkeypatch.setattr(tlap, "DIRECT_ELL_N", 16)
    data = make_energy_test_dataset(600, 32, seed=33).astype(np.float32)
    d = tmp_path / "ell"
    jshards.write_shards(data, d, rows_per_shard=200)
    kw = dict(max_clusters=12, radius=20.0, block_rows=256, sample_rows=600)
    if built_by == "jax":
        built = jst.StreamingIndex.build_from_store(d, _params(JGraphParams), **kw)
        other = tst.StreamingIndex.load(d, device=CPU)
    else:
        built = tst.StreamingIndex.build_from_store(d, _params(TGraphParams), device=CPU, **kw)
        other = jst.StreamingIndex.load(d)
    assert built.gl.is_ell_backed and other.gl.is_ell_backed
    assert (d / tst.GRAPH_ELL_FILE).exists() and not (d / tst.GRAPH_FILE).exists()
    Q = data[[17, 301]] + 0.01
    a, b = built.search_batch(Q, K), other.search_batch(Q, K)
    assert np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]), atol=TOL_SCORE, rtol=0)
    assert int(np.asarray(a[0])[0, 0]) == 17


@pytest.fixture(scope="module")
def energy_store(tmp_path_factory):
    """An energy-mode store with a JL projection, written by the reference
    (in-memory energy build → ``ShardedArrowSpace.to_store``), and both
    packages' indexes on it, sketches resident (small blocks: the scan
    merges across blocks)."""
    from matternet_rs_tpu import energymaps as em
    from matternet_rs_tpu.builder import ArrowSpaceBuilder
    from matternet_rs_tpu.parallel import make_mesh
    from matternet_rs_tpu.parallel.index import ShardedArrowSpace

    data = make_energy_test_dataset(1200, 128, seed=7).astype(np.float32)
    b = (ArrowSpaceBuilder().with_lambda_graph(1.0, 5).with_sparsity_check(False)
         .with_cluster_params(max_clusters=40, radius=120.0).with_dims_reduction(True).with_seed(9))
    aspace, gl = b.build_energy(data, em.EnergyParams(optical_tokens=16, neighbor_k=5, candidate_m=8))
    assert aspace.projection is not None          # 128 → 64
    sa = ShardedArrowSpace.from_arrowspace(aspace, gl, mesh=make_mesh(8))
    d = tmp_path_factory.mktemp("energy_store")
    sa.to_store(d)
    ji = jst.StreamingIndex.load(d)
    ti = tst.StreamingIndex.load(d, device=CPU)
    for idx in (ji, ti):
        idx.block_rows = 512
        idx.build_sketch(persist=False)
    return ji, ti, data


def test_energy_store_with_projection_loads(energy_store):
    ji, ti, _ = energy_store
    assert ti.sub_centroids is not None and ti.projection is not None
    assert (ti.projection.original_dim, ti.projection.reduced_dim, ti.projection.seed) == \
        (ji.projection.original_dim, ji.projection.reduced_dim, ji.projection.seed)
    assert np.array_equal(ti.subcentroid_lambdas, ji.subcentroid_lambdas)


def test_port_rewritten_energy_store_loads_in_the_reference(energy_store, tmp_path):
    """The port's ``_save_meta`` of an energy store with a projection
    (index.json, graph.bin, energy.npz) is read back by the reference, and
    both search it alike."""
    import shutil

    ji, ti, data = energy_store
    d = tmp_path / "rewritten"
    shutil.copytree(ti.directory, d)
    moved = tst.StreamingIndex.load(d, device=CPU)
    moved._save_meta()
    assert (d / tst.GRAPH_FILE).read_bytes() == (ti.directory / tst.GRAPH_FILE).read_bytes()
    back = jst.StreamingIndex.load(d)
    assert back.projection is not None and back.projection.seed == ji.projection.seed
    assert np.array_equal(back.subcentroid_lambdas, ji.subcentroid_lambdas)
    assert _index_json(d) == _index_json(ti.directory)
    Q = data[[3, 700]]
    ri, _ = back.search_energy_batch(Q, K)
    gi, _ = ti.search_energy_batch(Q, K)
    assert np.array_equal(np.asarray(ri), gi)


def test_energy_query_lambdas_match(energy_store):
    ji, ti, data = energy_store
    Q = data[:40]
    ql_j = np.asarray(ji._query_lambdas(jnp.asarray(Q)))
    ql_t = ti._query_lambdas(ti._queries(Q)).numpy()
    assert np.array_equal(ql_t, ql_j)
    assert ti.prepare_query_lambda(Q[3]) == pytest.approx(ji.prepare_query_lambda(Q[3]), abs=0)


def test_streamed_energy_search_matches(energy_store):
    ji, ti, data = energy_store
    Q = data[[10, 500, 1199]]
    ri, rs = ji.search_energy_batch(Q, K)
    gi, gs = ti.search_energy_batch(Q, K)
    assert np.array_equal(np.asarray(ri), gi)
    np.testing.assert_allclose(gs, np.asarray(rs), atol=TOL_SCORE, rtol=0)
    one_t, one_j = ti.search_energy(Q[0], K), ji.search_energy(Q[0], K)
    assert [i for i, _ in one_t] == [i for i, _ in one_j]
    np.testing.assert_allclose([s for _, s in one_t], [s for _, s in one_j], atol=TOL_SCORE, rtol=0)


@pytest.mark.parametrize("refine", [True, False])
def test_energy_sketch_search_matches(energy_store, refine):
    ji, ti, data = energy_store
    Q = data[[10, 500, 1199, 7]]
    ri, rs = ji.search_energy_batch_sketch(Q, K, refine=refine)
    gi, gs = ti.search_energy_batch_sketch(Q, K, refine=refine)
    assert np.array_equal(np.asarray(ri), gi)
    np.testing.assert_allclose(gs, np.asarray(rs), atol=TOL_SCORE, rtol=0)
    one_t = ti.search_energy_sketch(Q[1], K, refine=refine)
    one_j = ji.search_energy_sketch(Q[1], K, refine=refine)
    assert [i for i, _ in one_t] == [i for i, _ in one_j]


def _write_energy_store(aspace, gl, directory):
    """An energy store of the port's in-memory energy index, laid out as
    the reference's ``ShardedArrowSpace.to_store`` lays it out: the rows as
    shards, the raw λ (``min + λ·range``), the graph, ``energy.npz`` and
    ``index.json``."""
    from matternet_rs_tpu_torch.graph import GraphLaplacian

    tshards.write_shards(aspace.data.numpy(), directory)
    raw = aspace.min_lambdas + aspace.lambdas.numpy().astype(np.float64) * aspace.range_lambdas
    (directory / tst.LAMBDA_FILE).write_bytes(raw.astype(np.float32).tobytes())
    tst.StreamingIndex(
        directory=directory,
        gl=GraphLaplacian(matrix=gl.matrix, init_data=gl.init_data, nnodes=gl.nnodes,
                          graph_params=gl.graph_params),
        taumode=aspace.taumode, min_lambdas=aspace.min_lambdas, range_lambdas=aspace.range_lambdas,
        n_items=aspace.nitems, n_features=aspace.nfeatures,
        sub_centroids=aspace.sub_centroids.numpy(), subcentroid_lambdas=aspace.subcentroid_lambdas,
        projection=aspace.projection, device=CPU,
    )._save_meta()


@pytest.fixture(scope="module")
def port_energy_store(tmp_path_factory):
    """The port's own energy build (the reference store's data and
    settings above), written as a store, loaded by both packages."""
    from matternet_rs_tpu_torch import energymaps as tem
    from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder

    data = make_energy_test_dataset(1200, 128, seed=7).astype(np.float32)
    b = (ArrowSpaceBuilder(device=CPU).with_lambda_graph(1.0, 5).with_sparsity_check(False)
         .with_cluster_params(max_clusters=40, radius=120.0).with_dims_reduction(True).with_seed(9))
    aspace, gl = b.build_energy(data, tem.EnergyParams(optical_tokens=16, neighbor_k=5, candidate_m=8))
    d = tmp_path_factory.mktemp("port_energy_store")
    _write_energy_store(aspace, gl, d)
    ji, ti = jst.StreamingIndex.load(d), tst.StreamingIndex.load(d, device=CPU)
    for idx in (ji, ti):
        idx.block_rows = 512
        idx.build_sketch(persist=False)
    return aspace, gl, ji, ti, data


def test_port_energy_store_is_served_alike_by_both_packages(port_energy_store):
    from matternet_rs_tpu_torch import energymaps as tem

    aspace, gl, ji, ti, data = port_energy_store
    assert ti.sub_centroids is not None and ji.projection.seed == 9
    assert _index_json(ti.directory)["energy_mode"]
    Q = data[[10, 500, 1199, 7]] + 0.01
    ri, rs = ji.search_energy_batch(Q, K)
    gi, gs = ti.search_energy_batch(Q, K)
    assert np.array_equal(np.asarray(ri), gi)
    np.testing.assert_allclose(gs, np.asarray(rs), atol=TOL_SCORE, rtol=0)
    for refine in (True, False):
        rj = ji.search_energy_batch_sketch(Q, K, refine=refine)
        rt = ti.search_energy_batch_sketch(Q, K, refine=refine)
        assert np.array_equal(np.asarray(rj[0]), rt[0])
    # Streamed against the in-memory energy scan of the same index.
    mi, md = tem.search_energy_batch(aspace, Q, gl, K)
    lam_store = np.clip((np.fromfile(ti.directory / tst.LAMBDA_FILE, np.float32) - ti.min_lambdas)
                        / ti.range_lambdas, 0, 1).astype(np.float32)
    tol = energy_store_tolerance(lam_store, aspace.lambdas.numpy())
    assert not same_k_mismatches(mi, md, gi, gs, tol)
    si, ss = ti.search_energy_batch_sketch(Q, K, refine=True)
    assert not same_k_mismatches(mi, md, si, ss, tol)


def test_energy_methods_refuse_an_eigen_store(pair):
    _, ti, data = pair
    for call in (lambda: ti.search_energy_batch(data[:2], K),
                 lambda: ti.search_energy_batch_sketch(data[:2], K)):
        with pytest.raises(ValueError, match="not an energy-mode index"):
            call()


# ----------------------------------------------------------- streamed scans
@pytest.fixture(scope="module")
def small_pair(tmp_path_factory):
    data = _clustered(2000, 16, seed=11)
    ji, ti = _build_pair(tmp_path_factory.mktemp("stream_small"), data, 512, 700)
    return ji, ti, data


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("block_rows", [128, 512, 1500, 4096])
@pytest.mark.parametrize("k", [1, 10, 2005])
def test_search_batch_matches_reference(small_pair, quantized, block_rows, k):
    """Exact and bf16 streamed scans across block sizes (the last block
    ragged or the whole store in one) and at k past N."""
    ji, ti, data = small_pair
    ji.block_rows = ti.block_rows = block_rows
    try:
        Q = _queries(data, 5, seed=block_rows + k)
        kk = min(k, len(data))
        ri, rs = ji.search_batch(Q, kk + 1 if kk < len(data) else kk, quantized=quantized)
        gi, gs = ti.search_batch(Q, k, quantized=quantized)
    finally:
        ji.block_rows = ti.block_rows = 512
    ri, rs = np.asarray(ri), np.asarray(rs)
    assert gi.shape == (5, kk) and gi.dtype == np.int64
    if kk < len(data):
        assert not topk_mismatches(ri, rs, gi, gs, 1e-5)
    else:
        assert not same_k_mismatches(ri, rs, gi, gs, 1e-5)
        assert sorted(gi[0].tolist()) == list(range(len(data)))
    np.testing.assert_allclose(gs, rs[:, :kk], atol=TOL_SCORE, rtol=0)


def test_search_single_and_errors(pair):
    ji, ti, data = pair
    assert [i for i, _ in ti.search(data[17], K)] == [i for i, _ in ji.search(data[17], K)]
    assert ti.search(data[17], K)[0][0] == 17
    with pytest.raises(ValueError, match="doesn't match index dimension"):
        ti.search_batch(np.zeros((2, 5), np.float32), K)
    with pytest.raises(ValueError, match="alpha vector length"):
        ti.search_batch(data[:3], K, alpha=np.array([0.5, 0.6]))


def test_per_query_alpha_matches_reference(pair):
    ji, ti, data = pair
    Q = _queries(data, 4, seed=9)
    al = np.array([0.2, 0.5, 0.7, 1.0], np.float32)
    ri, rs = ji.search_batch(Q, K + 1, alpha=al)
    gi, gs = ti.search_batch(Q, K, alpha=al)
    assert not topk_mismatches(np.asarray(ri), np.asarray(rs), gi, gs, 1e-5)


# ----------------------------------------------------------- sketch scans
def _sketch_bound(ti, Q, ids, alpha):
    """Per entry: 2·F·2⁻²⁴·α·mult·Σ|q_bf16·x8|/‖q‖ + 1e-6 — two f32 sums of
    the same exact products in different orders, then the blend."""
    X8s, mults, _, _ = ti._sketch
    f = X8s.shape[2]
    X8f = X8s.reshape(-1, f).float()
    mf = mults.reshape(-1)
    Qb = torch.from_numpy(Q).to(torch.bfloat16).float()
    ids_t = torch.from_numpy(np.maximum(ids, 0))
    absdot = torch.einsum("bf,bkf->bk", Qb.abs(), X8f[ids_t].abs())
    qn = torch.linalg.norm(torch.from_numpy(Q), dim=1).clamp(min=1e-12)
    return (2 * f * 2.0 ** -24 * alpha * mf[ids_t] * absdot / qn[:, None] + 1e-6).numpy()


def _reference_sketch_inputs(ji, Q):
    Qj = jnp.asarray(Q)
    return Qj, ji._query_lambdas(Qj)


@pytest.mark.parametrize("kk", [10, 40, 200, 4096, 5000])
def test_carry_scan_matches_reference(pair, kk):
    """``_sketch_scan_topk`` on the same sketch and queries: per-block
    selection below and above the reference's approx_max_k threshold
    (kb·16 ≤ blk), the carry wider than a block (kk = 5000)."""
    ji, ti, data = pair
    Q = _queries(data, 6, seed=kk)
    Qj, qlj = _reference_sketch_inputs(ji, Q)
    rs, ri = jst._sketch_scan_topk(*ji._sketch, Qj, qlj, jnp.float32(0.7), jnp.float32(ji.min_lambdas),
                                   jnp.float32(ji.range_lambdas), kk=kk)
    Qt = ti._queries(Q)
    gs, gi = tst._sketch_scan_topk(*ti._sketch, Qt, ti._query_lambdas(Qt), 0.7, ti.min_lambdas,
                                   ti.range_lambdas, kk=kk)
    rs, ri, gs, gi = np.asarray(rs), np.asarray(ri), gs.numpy(), gi.numpy()
    bound = _sketch_bound(ti, Q, ri, 0.7)
    assert np.all(np.abs(gs - rs) <= bound)
    swapped = gi != ri
    assert np.all(np.abs(gs - rs)[swapped] <= 2 * bound[swapped])


@pytest.mark.parametrize("rows_out,kfinal", [(40, 10), (128, 10), (512, 10), (300, 60)])
def test_maxfirst_scan_matches_reference(pair, reference_maxfirst_interpret, rows_out, kfinal):
    """``_sketch_maxfirst_topk`` (kernels D and E plain here; the Pallas
    kernels in interpret mode there) on the same sketch and 8 queries."""
    ji, ti, data = pair
    Q = _queries(data, 8, seed=rows_out)
    Qj, qlj = _reference_sketch_inputs(ji, Q)
    X8f, mult_f, lam_f = ji._sketch_flat_views()
    Qp = jnp.pad(Qj, ((0, 0), (0, X8f.shape[1] - Qj.shape[1])))
    a = jnp.full((8,), 0.7, jnp.float32)
    rs, ri = jst._sketch_maxfirst_topk(X8f, mult_f, lam_f, Qp, qlj, a, rows_out=rows_out,
                                       kfinal=kfinal, n_items=jnp.int32(ji.n_items))
    Qt = ti._queries(Q)
    tf, tm, tl = ti._sketch_flat_views()
    gs, gi = tst._sketch_maxfirst_topk(tf, tm, tl, Qt, ti._query_lambdas(Qt),
                                       torch.full((8,), 0.7), rows_out=rows_out, kfinal=kfinal,
                                       n_items=ti.n_items)
    rs, ri, gs, gi = np.asarray(rs), np.asarray(ri), gs.numpy(), gi.numpy()
    assert gi.shape == ri.shape
    bound = _sketch_bound(ti, Q, ri, 0.7)
    assert np.all(np.abs(gs - rs) <= 2 * bound)
    # Ids agree wherever no near tie (within the bound) allows a swap.
    ties = np.abs(gs - rs) <= 2 * bound
    assert np.all((gi == ri) | ties)
    assert np.mean(gi == ri) > 0.95


@pytest.mark.parametrize("maxfirst", [True, False])
@pytest.mark.parametrize("candidates", [None, 64, 4096])
def test_refined_sketch_search_matches_reference(pair, reference_maxfirst_interpret, maxfirst,
                                                 candidates):
    ji, ti, data = pair
    ji.sketch_maxfirst = ti.sketch_maxfirst = maxfirst
    try:
        Q = _queries(data, 8, seed=31)
        ri, rs = ji.search_batch_sketch(Q, K, candidates=candidates)
        gi, gs = ti.search_batch_sketch(Q, K, candidates=candidates)
        one = ti.search_sketch(Q[2], K, candidates=candidates)
    finally:
        ji.sketch_maxfirst = ti.sketch_maxfirst = None
    assert np.array_equal(np.asarray(ri), gi)
    np.testing.assert_allclose(gs, np.asarray(rs), atol=TOL_SCORE, rtol=0)
    assert [i for i, _ in one] == gi[2].tolist()


@pytest.mark.parametrize("maxfirst", [True, False])
def test_unrefined_sketch_search_matches_reference(pair, reference_maxfirst_interpret, maxfirst):
    ji, ti, data = pair
    ji.sketch_maxfirst = ti.sketch_maxfirst = maxfirst
    try:
        Q = _queries(data, 8, seed=32)
        ri, rs = ji.search_batch_sketch(Q, K, refine=False)
        gi, gs = ti.search_batch_sketch(Q, K, refine=False)
    finally:
        ji.sketch_maxfirst = ti.sketch_maxfirst = None
    ri, rs = np.asarray(ri), np.asarray(rs)
    bound = _sketch_bound(ti, Q, ri, 0.7)
    assert np.all(np.abs(gs - rs) <= 2 * bound)
    assert np.all((gi == ri) | (np.abs(gs - rs) <= 2 * bound))


def test_maxfirst_refined_equals_carry_refined_with_a_block_of_candidates(pair):
    """The maxima-first contract: with candidates covering a block, the
    refined results equal the carry scan's (ids, score bits)."""
    _, ti, data = pair
    Q = _queries(data, 16, seed=3)
    ti.sketch_maxfirst = True
    try:
        fi, fs = ti.search_batch_sketch(Q, K, candidates=ti.block_rows)
        ti.sketch_maxfirst = False
        ci, cs = ti.search_batch_sketch(Q, K, candidates=ti.block_rows)
    finally:
        ti.sketch_maxfirst = None
    assert np.array_equal(fi, ci) and np.array_equal(fs.view(np.int32), cs.view(np.int32))


def test_sketch_reload_from_file_searches_alike(tmp_path):
    """``build_sketch`` reloaded from ``sketch.bin`` (the native int8
    reader) gives the stacked arrays and results of the quantising pass."""
    data = _clustered(5000, 16, seed=6)
    d = tmp_path / "s"
    tshards.write_shards(data, d, rows_per_shard=1800)
    ti = tst.StreamingIndex.build_from_store(d, _params(TGraphParams), max_clusters=16, radius=20.0,
                                             block_rows=1024, sample_rows=4096, device=CPU)
    fresh = [t.clone() for t in ti.build_sketch(persist=True)]
    assert (d / tst.SKETCH_FILE).exists()
    again = tst.StreamingIndex.load(d, device=CPU)
    reloaded = again.build_sketch()
    for a, b in zip(fresh, reloaded):
        assert torch.equal(a, b)
    Q = _queries(data, 4, seed=2)
    a, b = ti.search_batch_sketch(Q, K), again.search_batch_sketch(Q, K)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    Xp = ti.sketch_host_buffers(nb_pad=8)
    assert Xp[0].shape == (8, 1024, 16) and Xp[3][5:].tolist() == [0, 0, 0]


# ----------------------------------------------------------- routing
class _Shape:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("policy", [None, True, False])
@pytest.mark.parametrize("b", [1, 7, 8, 256, 1025])
@pytest.mark.parametrize("shape", [
    (8, 131_072, 96),        # 1M flat rows: below the crossover
    (39, 131_072, 96),       # 5.1M: above it
    (77, 131_072, 96),       # 10.1M
    (77, 131_072, 130),      # F padded to 256 by the reference's reckoning
    (9, 4096, 32),
    (40, 131_072, 1024),     # n·f_pad past 4 GiB
    (3, 1000, 32),           # flat length not a whole number of tiles
])
@pytest.mark.parametrize("cand", [32, 40, 512, 10**6])
def test_sketch_fused_ok_decides_as_the_reference(reference_maxfirst_interpret, policy, b, shape,
                                                  cand):
    def fake(mod):
        idx = object.__new__(mod.StreamingIndex)
        idx.__dict__.update(_sketch=(_Shape(shape),), _sketch_suffix_pad=True,
                            sketch_maxfirst=policy)
        return idx

    b_pad = max(8, 1 << max(b - 1, 1).bit_length())
    for kk in (1, 10):
        assert tst.StreamingIndex._sketch_fused_ok(fake(tst), b_pad, kk, cand) == \
            jst.StreamingIndex._sketch_fused_ok(fake(jst), b_pad, kk, cand)


def test_maxfirst_flat_views_are_views(pair):
    _, ti, _ = pair
    ti._sketch_flat = None
    X8f, mult_f, lam_f = ti._sketch_flat_views()
    X8s, mults, lams, _ = ti._sketch
    assert X8f.data_ptr() == X8s.data_ptr() and X8f.shape == (X8s.shape[0] * X8s.shape[1], X8s.shape[2])
    assert mult_f.data_ptr() == mults.data_ptr()
    assert ti._sketch_flat_views()[2] is lam_f          # normalised once
    assert float(lam_f.min()) >= 0.0 and float(lam_f.max()) <= 1.0


def test_pickle_drops_and_remakes_the_lock(pair):
    _, ti, _ = pair
    clone = pickle.loads(pickle.dumps(ti))
    assert clone._sketch_flat_lock is not ti._sketch_flat_lock
    assert clone.n_items == ti.n_items and clone.device == ti.device


def test_entry_points_need_a_card_unless_asked_for_the_cpu(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points take it")
    _, ti, _ = pair
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.StreamingIndex.load(ti.directory)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.StreamingIndex.build_from_store(ti.directory, _params(TGraphParams), 16, 20.0)
    probe = tst.StreamingIndex.load(ti.directory, device=CPU)
    probe.device = None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe.build_sketch(persist=False)


def test_module_surface_matches_the_reference():
    names = ["INDEX_FILE", "LAMBDA_FILE", "GRAPH_FILE", "GRAPH_ELL_FILE", "ENERGY_FILE",
             "SKETCH_FILE", "SKETCH_META_FILE", "MAXFIRST_MIN_ROWS", "DEFAULT_BLOCK_ROWS"]
    assert {n: getattr(tst, n) for n in names} == {n: getattr(jst, n) for n in names}
    methods = [m for m in vars(jst.StreamingIndex) if callable(getattr(jst.StreamingIndex, m))
               and not m.startswith("__")]
    assert [m for m in methods if not hasattr(tst.StreamingIndex, m)] == []
    for fn in ("scan_sketch_blocks", "suffix_padded", "_sketch_scan_topk", "_sketch_maxfirst_topk",
               "_score_block_batch", "_energy_block_batch", "_refine_exact_topk",
               "_refine_energy_topk", "_quantize_rows", "_publish_sketch_files", "_host_bf16"):
        assert callable(getattr(tst, fn))
