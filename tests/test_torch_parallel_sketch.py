"""Port vs reference: the mesh-sharded resident sketch
(``parallel/sketch.py``): the carry scan on 8 slots and 2 × 4, energy
mode, the sketch carried across with ``convert``, and the maxima-first
local scan (kernels D and E: their plain versions here, the reference's
Pallas kernels in interpret mode).

Both packages read one store built by the reference. Tolerances: the
sketch-precision scan scores under the same-k near-tie rule at 1e-5 (the
same bf16 products summed in different orders); refined results (exact
f32 rescores from disk) at 1e-6.
"""

import functools

import numpy as np
import pytest
import torch

from matternet_rs_tpu.graph import GraphParams as JGraphParams
from matternet_rs_tpu.index import streaming as jst
from matternet_rs_tpu.ops.pallas import tilemax_fused as tmf
from matternet_rs_tpu.parallel import mesh as jmesh
from matternet_rs_tpu.parallel.sketch import ShardedSketch as JSketch
from matternet_rs_tpu.storage import shards as jshards

from matternet_rs_tpu_torch import convert
from matternet_rs_tpu_torch.index import streaming as tst
from matternet_rs_tpu_torch.parallel import mesh as tmesh
from matternet_rs_tpu_torch.parallel.sketch import ShardedSketch as TSketch
from matternet_rs_tpu_torch.utils.parity import same_k_mismatches

CPU = torch.device("cpu")
K = 10


def _clustered(n, f, seed, centres=8):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centres, f)) * 4.0
    return (c[rng.integers(0, centres, n)] + rng.normal(size=(n, f))).astype(np.float32)


def _store(tmp, data, block_rows, energy=False):
    jshards.write_shards(data, tmp, rows_per_shard=2000)
    params = JGraphParams(eps=1.0, k=6, topk=6, sparsity_check=False)
    ji = jst.StreamingIndex.build_from_store(tmp, params, max_clusters=16, radius=20.0,
                                             block_rows=block_rows, sample_rows=4096)
    return ji, tst.StreamingIndex.load(tmp, device=CPU)


def _meshes(kind):
    if kind == "1d":
        return jmesh.make_mesh(8), tmesh.make_mesh(8, devices=[CPU] * 8)
    return jmesh.make_mesh_2d(2, 4), tmesh.make_mesh_2d(2, 4, devices=[CPU] * 8)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """4,999 × 16 in 256-row blocks: 20 blocks, padded to 24 on 8 slots."""
    data = _clustered(4999, 16, seed=41)
    ji, ti = _store(tmp_path_factory.mktemp("sharded_sketch"), data, 256)
    return ji, ti, data


def _queries(data, b, seed):
    return data[np.random.default_rng(seed).choice(len(data), b, replace=False)] + 0.01


def _close(ref, got, tol):
    ref_i, ref_s = np.asarray(ref[0]), np.asarray(ref[1], np.float64)
    got_i, got_s = np.asarray(got[0]), np.asarray(got[1], np.float64)
    assert got_i.shape == ref_i.shape
    assert not same_k_mismatches(ref_i, ref_s, got_i, got_s, tol)
    assert np.mean(got_i == ref_i) > 0.95


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_layout_equals_reference(small, kind):
    ji, ti, _ = small
    jm, tm = _meshes(kind)
    js, ts = JSketch(ji, jm), TSketch(ti, tm)
    assert ts.blocks_per_device == js.blocks_per_device == 3
    assert ts.hbm_bytes_per_device == js.hbm_bytes_per_device
    assert ts._suffix_pad == js._suffix_pad
    bases = np.asarray(js._shards[4])
    assert [int(r[0]) for _, r in ts._row_info.local()] == bases.tolist()
    for name, j in zip(("X8", "mult", "lam", "valid"), js._shards[:4]):
        assert np.array_equal(ts._shards[name].gather().numpy(), np.asarray(j)), name


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("candidates", [None, 64, 256])
def test_carry_scan_search(small, kind, refine, candidates):
    ji, ti, data = small
    jm, tm = _meshes(kind)
    js, ts = JSketch(ji, jm), TSketch(ti, tm)
    Q = _queries(data, 6, seed=7)
    al = np.linspace(0.5, 0.9, 6).astype(np.float32)
    ref = js.search_batch(Q, K, al, candidates=candidates, refine=refine)
    got = ts.search_batch(Q, K, al, candidates=candidates, refine=refine)
    _close(ref, got, 1e-6 if refine else 1e-5)
    one = ts.search(Q[1], K, 0.7, candidates=candidates, refine=refine)
    _close(js.search_batch(Q[1:2], K, 0.7, candidates=candidates, refine=refine),
           ([[i for i, _ in one]], [[s for _, s in one]]), 1e-6 if refine else 1e-5)


def test_sketch_carried_across_with_convert(small):
    ji, ti, data = small
    jm, tm = _meshes("1d")
    js = JSketch(ji, jm)
    ts = convert.sharded_sketch_from_arrays(ti, tm, *(np.asarray(a) for a in js._shards[:4]))
    Q = _queries(data, 4, seed=9)
    _close(js.search_batch(Q, K, refine=False), ts.search_batch(Q, K, refine=False), 1e-5)


def test_energy_sketch_search(tmp_path):
    """An energy store (``energy.npz`` beside the blended store): the
    energy carry scan through the sharded sketch, sketch-only and refined."""
    data = _clustered(2300, 16, seed=43)
    ji, _ = _store(tmp_path, data, 128)
    rng = np.random.default_rng(5)
    ji.sub_centroids = rng.normal(size=(12, 16)).astype(np.float32)
    ji.subcentroid_lambdas = np.sort(rng.random(12)).astype(np.float32)
    ji._save_meta()
    ti = tst.StreamingIndex.load(tmp_path, device=CPU)
    jm, tm = _meshes("1d")
    js, ts = JSketch(ji, jm), TSketch(ti, tm)
    Q = _queries(data, 5, seed=3)
    for refine in (False, True):
        ri, rd = js.search_energy_batch(Q, K, refine=refine)
        gi, gd = ts.search_energy_batch(Q, K, refine=refine)
        # Distances ascending: the near-tie rule on their negations.
        _close((ri, -np.asarray(rd)), (gi, -gd), 1e-6)
    assert [i for i, _ in ts.search_energy(Q[0], K)] == np.asarray(
        js.search_energy_batch(Q[:1], K)[0])[0].tolist()
    blended = TSketch(tst.StreamingIndex.load(tmp_path, device=CPU), tm)
    blended.index.sub_centroids = None
    with pytest.raises(ValueError, match="not an energy-mode index"):
        blended.search_energy_batch(Q, K)


@pytest.fixture()
def reference_maxfirst_interpret(monkeypatch):
    """The reference's maxima-first kernels in interpret mode and its
    TPU-platform gate replaced by the shape envelope (its own tests' way)."""
    monkeypatch.setattr(tmf, "tilemax_only", functools.partial(tmf.tilemax_only, interpret=True))
    monkeypatch.setattr(tmf, "slab_dots_ring", functools.partial(tmf.slab_dots_ring, interpret=True))

    def cpu_supported(nn, ff, bb, tile, subs=tmf.SUBS):
        return (nn >= tile and ff <= tmf.MAX_FUSED_F_WIDE
                and tmf.MIN_FUSED_B <= bb <= tmf.MAX_FUSED_B and tile % (subs * 128) == 0)

    monkeypatch.setattr(tmf, "tilemax_only_supported", cpu_supported)


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """34,000 × 128 in 4,096-row blocks: 9 blocks, 36,864 flat rows on one
    slot — the maxima-first envelope (the reference's needs F % 128 = 0)."""
    data = _clustered(34_000, 128, seed=47)
    ji, ti = _store(tmp_path_factory.mktemp("sharded_sketch_wide"), data, 4096)
    return ji, ti, data


@pytest.mark.parametrize("refine", [False, True])
def test_maxfirst_local_scan_matches_reference(wide, reference_maxfirst_interpret, refine):
    ji, ti, data = wide
    js = JSketch(ji, jmesh.make_mesh(1), sketch_maxfirst=True)
    ts = TSketch(ti, tmesh.make_mesh(1, devices=[CPU]), sketch_maxfirst=True)
    assert ts._maxfirst_ok(8, K, 64) and js._maxfirst_ok(8, K, 64)
    ts.sketch_maxfirst = js.sketch_maxfirst = None
    assert not ts._maxfirst_ok(8, K, 64) and not js._maxfirst_ok(8, K, 64)   # below 4M rows
    ts.sketch_maxfirst = js.sketch_maxfirst = True
    Q = _queries(data, 5, seed=13)                     # B = 5 pads to 8 for the route
    _close(js.search_batch(Q, K, candidates=128, refine=refine),
           ts.search_batch(Q, K, candidates=128, refine=refine), 1e-6 if refine else 2e-5)


def test_maxfirst_on_two_slots_against_the_carry_scan(monkeypatch):
    """Two slots of 36,864 flat rows each through the maxima-first scan:
    its refined results are the carry scan's wherever the slab selection
    kept the candidates (≥ 95%), and a missed candidate can only lower a
    score; the slots' bases give global ids."""
    from matternet_rs_tpu_torch.ops import search as so

    data = _clustered(70_000, 16, seed=53)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        from matternet_rs_tpu_torch.graph import GraphParams
        from matternet_rs_tpu_torch.storage import shards as tshards

        tshards.write_shards(data, tmp, rows_per_shard=20_000)
        ti = tst.StreamingIndex.build_from_store(
            tmp, GraphParams(eps=1.0, k=6, topk=6, sparsity_check=False), max_clusters=16,
            radius=20.0, block_rows=4096, sample_rows=4096, device=CPU)
        tm = tmesh.make_mesh(2, devices=[CPU] * 2)
        ts = TSketch(ti, tm, sketch_maxfirst=True)
        calls = []
        real = so.fused_rescored_path
        monkeypatch.setattr(so, "fused_rescored_path",
                            lambda *a, **kw: calls.append(a[0]) or real(*a, **kw))
        rows = np.array([5, 36_000, 40_000, 69_999])
        Q = data[rows]
        fi, fs = ts.search_batch(Q, K, candidates=256)
        assert calls and all(c == 36_864 for c in calls)
        assert np.array_equal(fi[:, 0], rows)
        ts.sketch_maxfirst = False
        ci, cs = ts.search_batch(Q, K, candidates=256)
        same = fi == ci
        assert same.mean() >= 0.95
        np.testing.assert_allclose(fs[same], cs[same], atol=1e-6)
        assert np.all(fs <= cs + 1e-6)
