"""Parquet persistence of the port (``matternet_rs_tpu_torch.storage.parquet``)
against the reference's: the same files, read by either package.

Tolerances: stored values bit for bit (float32 through float64 and back);
a checkpoint written by one package and searched by the other: ids under
the near-tie rule, scores 1e-5 (``utils/parity.py``); a reload within one
package searches bit for bit; metadata floats 1e-5·max(1, |x|).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matternet_rs_tpu import builder as jbuilder
from matternet_rs_tpu.storage import StorageError as JStorageError
from matternet_rs_tpu.storage import parquet as jpq

from matternet_rs_tpu_torch import builder as tbuilder
from matternet_rs_tpu_torch.storage import StorageError
from matternet_rs_tpu_torch.storage import parquet as tpq
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset
from matternet_rs_tpu_torch.utils.parity import topk_mismatches

K = 10


def _configure(b, jl=False):
    b = (b.with_lambda_graph(1.0, 6).with_sparsity_check(False)
         .with_cluster_params(max_clusters=16, radius=30.0).with_seed(5).with_sampling(None))
    return b.with_dims_reduction(True) if jl else b


@pytest.fixture(scope="module", params=[False, True], ids=["eigen", "jl"])
def built(request):
    X = make_energy_test_dataset(1500, 120, seed=23).astype(np.float32)
    jb, tb = _configure(jbuilder.ArrowSpaceBuilder(), request.param), _configure(
        tbuilder.ArrowSpaceBuilder(device="cpu"), request.param)
    ja, jgl = jb.build(X)
    ta, tgl = tb.build(X)
    Q = X[np.random.default_rng(1).choice(len(X), 12, replace=False)]
    return request.param, X, Q, (ja, jgl, jb), (ta, tgl, tb)


def test_dense_sparse_lambda_round_trips_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(37, 9)).astype(np.float32)
    sparse = np.where(rng.random((20, 20)) < 0.2, rng.normal(size=(20, 20)), 0.0)
    lam = rng.random(37).astype(np.float32)
    for writer, reader in ((tpq, jpq), (jpq, tpq), (tpq, tpq)):
        d = tmp_path / f"{writer.__name__.split('.')[0]}-{reader.__name__.split('.')[0]}"
        writer.save_dense_matrix(dense, d, "m")
        writer.save_sparse_matrix(sparse, d, "s")
        writer.save_lambdas(lam, d, "l")
        assert np.array_equal(reader.load_dense_matrix(d / "m.parquet").astype(np.float32), dense)
        assert np.array_equal(reader.load_sparse_matrix(d / "s.parquet"), sparse)
        assert np.array_equal(reader.load_lambdas(d / "l.parquet").astype(np.float32), lam)
    # A tensor saves as its values.
    tpq.save_dense_matrix(torch.from_numpy(dense), tmp_path / "t", "m")
    assert np.array_equal(jpq.load_dense_matrix(tmp_path / "t" / "m.parquet"), dense.astype(np.float64))


def test_reference_checkpoint_loaded_by_the_port(built, tmp_path):
    jl, X, Q, (ja, jgl, jb), _ = built
    jpq.save_checkpoint(ja, jgl, jb, tmp_path, "ref")
    ta, tgl = tpq.load_arrowspace(tmp_path, "ref", device="cpu")
    assert ta.nitems == ja.nitems and ta.n_clusters == ja.n_clusters
    assert (ta.projection is None) == (not jl)
    if jl:
        assert (ta.projection.original_dim, ta.projection.reduced_dim, ta.projection.seed) == (
            ja.projection.original_dim, ja.projection.reduced_dim, ja.projection.seed)
        assert ta.reduced_dim == ja.reduced_dim
    assert np.array_equal(ta.lambdas.numpy(), np.asarray(ja.lambdas))
    ref_idx, ref_sc = ja.search_batch(Q, jgl, K + 1)
    idx, sc = ta.search_batch(Q, tgl, K)
    assert not topk_mismatches(ref_idx, ref_sc, idx, sc)


def test_port_checkpoint_loaded_by_the_reference(built, tmp_path):
    jl, X, Q, (ja, jgl, jb), (ta, tgl, tb) = built
    tpq.save_checkpoint(ta, tgl, tb, tmp_path, "port")
    ra, rgl = jpq.load_arrowspace(tmp_path, "port")
    assert (ra.projection is None) == (not jl)
    if jl:
        assert ra.projection == type(ra.projection)(
            ta.projection.original_dim, ta.projection.reduced_dim, ta.projection.seed)
    assert np.array_equal(np.asarray(ra.lambdas), ta.lambdas.numpy())
    idx, sc = ta.search_batch(Q, tgl, K)
    ref_idx, ref_sc = ra.search_batch(Q, rgl, K + 1)
    assert not topk_mismatches(ref_idx, ref_sc, idx, sc)


def test_reload_searches_bit_for_bit(built, tmp_path):
    """Within the port: the stored λ and stats, the rebuilt sorted index and
    the regenerated projection give the same ids and score bits."""
    _, X, Q, _, (ta, tgl, tb) = built
    tpq.save_checkpoint(ta, tgl, tb, tmp_path, "ck")
    ra, rgl = tpq.load_arrowspace(tmp_path, "ck", device="cpu")
    i1, s1 = ta.search_batch(Q, tgl, K)
    i2, s2 = ra.search_batch(Q, rgl, K)
    assert np.array_equal(i1, i2) and np.array_equal(s1.view(np.int32), s2.view(np.int32))
    assert torch.equal(ra.lambdas, ta.lambdas)
    lam = ta.prepare_query_item(Q[0], tgl)
    ra.drop_data()
    assert ra.data.shape == (0, X.shape[1]) and ra.nitems == len(X)
    assert ra.prepare_query_item(Q[0], rgl) == lam


def test_metadata_json_has_the_reference_keys_and_values(built, tmp_path):
    _, X, Q, (ja, jgl, jb), (ta, tgl, tb) = built
    jpq.save_checkpoint(ja, jgl, jb, tmp_path / "j", "ix")
    tpq.save_checkpoint(ta, tgl, tb, tmp_path / "t", "ix")
    ref = json.loads((tmp_path / "j" / "ix-arrowspace_metadata.json").read_text())
    got = json.loads((tmp_path / "t" / "ix-arrowspace_metadata.json").read_text())
    assert ref.keys() == got.keys()
    assert ref["builder"] == got["builder"]
    assert ref["arrowspace"].keys() == got["arrowspace"].keys()
    for key, v in ref["arrowspace"].items():
        if isinstance(v, float):
            assert abs(v - got["arrowspace"][key]) <= 1e-5 * max(1.0, abs(v)), key
        else:
            assert got["arrowspace"][key] == v, key
    assert ref["files"].keys() == got["files"].keys()
    for key, info in ref["files"].items():
        for field in ("filename", "file_type", "rows", "cols"):
            assert got["files"][key][field] == info[field], (key, field)
    assert tpq.config_summary(tb) == jpq.config_summary(jb)


def test_builder_persistence_hooks_write_the_reference_files(tmp_path):
    X = make_energy_test_dataset(600, 24, seed=4).astype(np.float32)
    jb = _configure(jbuilder.ArrowSpaceBuilder()).with_spectral(True).with_persistence("ix", tmp_path / "j")
    tb = _configure(tbuilder.ArrowSpaceBuilder(device="cpu")).with_spectral(True).with_persistence(
        "ix", tmp_path / "t")
    jb.build(X)
    ta, _ = tb.build(X)
    ref = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert ref == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert "ix-aspace-signals.parquet" in ref and "ix-raw_input.parquet" in ref
    assert np.array_equal(tpq.load_dense_matrix(tmp_path / "t" / "ix-raw_input.parquet"),
                          jpq.load_dense_matrix(tmp_path / "j" / "ix-raw_input.parquet"))
    assert np.array_equal(jpq.load_lambdas(tmp_path / "t" / "ix-lambdas.parquet").astype(np.float32),
                          ta.lambdas.numpy())


def test_load_graph_laplacian(built, tmp_path):
    _, X, Q, _, (ta, tgl, tb) = built
    tpq.save_checkpoint(ta, tgl, tb, tmp_path, "ck")
    gl = tpq.load_graph_laplacian(tmp_path, "ck", device="cpu")
    assert torch.equal(gl.matrix, tgl.matrix) and torch.equal(gl.init_data, tgl.init_data)
    ref = jpq.load_graph_laplacian(tmp_path, "ck")
    assert np.array_equal(np.asarray(ref.matrix), gl.matrix.numpy())


def test_missing_artifact_and_lambda_count_raise(built, tmp_path):
    _, X, Q, _, (ta, tgl, tb) = built
    tpq.save_checkpoint(ta, tgl, tb, tmp_path, "ck")
    tpq.save_lambdas(np.zeros(7, np.float32), tmp_path, "ck-lambdas")
    with pytest.raises(StorageError, match="lambda count"):
        tpq.load_arrowspace(tmp_path, "ck", device="cpu")
    (tmp_path / "ck-gl-matrix.parquet").unlink()
    with pytest.raises(StorageError, match="manifest lists artifact"):
        tpq.load_arrowspace(tmp_path, "ck", device="cpu")
    with pytest.raises(StorageError, match="missing file"):
        tpq.load_dense_matrix(tmp_path / "absent.parquet")
    with pytest.raises(StorageError, match="2-D"):
        tpq.save_dense_matrix(np.zeros(3), tmp_path, "bad")


def test_unwritable_directory_raises_storage_error(tmp_path):
    """A directory that cannot be made (its parent is a file) and a target
    that cannot be written (a directory of that name) raise
    ``StorageError`` in both packages, whatever the process's rights."""
    (tmp_path / "file").write_text("x")
    for mod, err in ((tpq, StorageError), (jpq, JStorageError)):
        with pytest.raises(err, match="cannot create"):
            mod.save_lambdas(np.ones(5), tmp_path / "file" / "sub", "x")
    (tmp_path / "d" / "x.parquet").mkdir(parents=True)
    for mod, err in ((tpq, StorageError), (jpq, JStorageError)):
        with pytest.raises(err, match="cannot write"):
            mod.save_lambdas(np.ones(5), tmp_path / "d", "x")


def _energy_builder(b):
    return (b.with_lambda_graph(1.0, 5).with_sparsity_check(False)
            .with_cluster_params(max_clusters=25, radius=16.0)
            .with_deterministic_clustering(True).with_dims_reduction(True).with_seed(4))


@pytest.fixture(scope="module")
def energy_built():
    from matternet_rs_tpu import energymaps as jem

    from matternet_rs_tpu_torch import energymaps as tem

    data = make_energy_test_dataset(300, 96, seed=2).astype(np.float32)
    jb = _energy_builder(jbuilder.ArrowSpaceBuilder())
    ja, jgl = jb.build_energy(data, jem.EnergyParams(optical_tokens=15, neighbor_k=5))
    tb = _energy_builder(tbuilder.ArrowSpaceBuilder(device="cpu"))
    ta, tgl = tb.build_energy(data, tem.EnergyParams(optical_tokens=15, neighbor_k=5))
    assert ja.sub_centroids is not None and ta.sub_centroids is not None
    Q = data[[3, 77, 150, 299]] + 0.01
    return Q, (ja, jgl, jb), (ta, tgl, tb)


def _energy_results(mod_em, aspace, gl, Q):
    """Energy scan and energy-mode search_batch of ``Q`` (numpy)."""
    ei, ed = mod_em.search_energy_batch(aspace, Q, gl, K)
    bi, bs = aspace.search_batch(Q, gl, K)
    return [np.asarray(a) for a in (ei, ed, bi, bs)]


@pytest.mark.parametrize("direction", ["reference-to-port", "port-to-reference", "port-to-port"])
def test_energy_checkpoint_round_trip(energy_built, tmp_path, direction):
    """An energy checkpoint saved by one package and loaded by the other
    (or by the port again) resumes in energy mode and searches alike:
    energy state equal, ids under the near-tie rule (energy scan: the
    tie-break term at a cosine tolerance of 1e-5; search_batch: 1e-5), and
    bit for bit within the port."""
    from matternet_rs_tpu import energymaps as jem

    from matternet_rs_tpu_torch import energymaps as tem
    from matternet_rs_tpu_torch.utils.parity import ENERGY_TIE_TOL, same_k_mismatches

    Q, (ja, jgl, jb), (ta, tgl, tb) = energy_built
    saver, src, src_gl, src_b = (jpq, ja, jgl, jb) if direction.startswith("reference") else (tpq, ta, tgl, tb)
    saver.save_checkpoint(src, src_gl, src_b, tmp_path, "en")
    meta = json.loads((tmp_path / "en-arrowspace_metadata.json").read_text())
    assert {"sub_centroids", "subcentroid_lambdas", "centroid_map"} <= set(meta["files"])
    if direction.endswith("reference"):
        ra, rgl = jpq.load_arrowspace(tmp_path, "en")
        got = _energy_results(jem, ra, rgl, Q)
        state = (np.asarray(ra.sub_centroids), np.asarray(ra.subcentroid_lambdas), np.asarray(ra.centroid_map))
    else:
        ra, rgl = tpq.load_arrowspace(tmp_path, "en", device="cpu")
        got = _energy_results(tem, ra, rgl, Q)
        state = (ra.sub_centroids.numpy(), ra.subcentroid_lambdas, ra.centroid_map)
        assert ra.item_norms is not None and ra.max_lambda_tie_group() == src.max_lambda_tie_group()
    assert rgl.energy
    assert np.array_equal(state[0], np.asarray(src.sub_centroids))
    assert np.array_equal(state[1], np.asarray(src.subcentroid_lambdas))
    assert np.array_equal(state[2], np.asarray(src.centroid_map)) and state[2].dtype == np.int64
    ref = _energy_results(jem if src is ja else tem, src, src_gl, Q)
    if direction == "port-to-port":
        for a, b in zip(ref, got):
            assert np.array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                                  b.view(np.int32) if b.dtype == np.float32 else b)
    else:
        assert not same_k_mismatches(ref[0], ref[1], got[0], got[1], ENERGY_TIE_TOL)
        assert not same_k_mismatches(ref[2], ref[3], got[2], got[3], 1e-5)


def test_energy_checkpoints_hold_the_same_files(energy_built, tmp_path):
    _, (ja, jgl, jb), (ta, tgl, tb) = energy_built
    jpq.save_checkpoint(ja, jgl, jb, tmp_path / "j", "en")
    tpq.save_checkpoint(ta, tgl, tb, tmp_path / "t", "en")
    assert sorted(p.name for p in (tmp_path / "j").iterdir()) == \
        sorted(p.name for p in (tmp_path / "t").iterdir())
    mj = json.loads((tmp_path / "j" / "en-arrowspace_metadata.json").read_text())["files"]
    mt = json.loads((tmp_path / "t" / "en-arrowspace_metadata.json").read_text())["files"]
    assert set(mj) == set(mt)
    for key in ("sub_centroids", "subcentroid_lambdas", "centroid_map"):
        assert (mj[key]["rows"], mj[key]["cols"]) == (mt[key]["rows"], mt[key]["cols"])


def test_load_arrowspace_places_the_space_on_the_device_asked(built, tmp_path):
    _, X, Q, _, (ta, tgl, tb) = built
    tpq.save_checkpoint(ta, tgl, tb, tmp_path, "ck")
    ra, rgl = tpq.load_arrowspace(tmp_path, "ck", device="cpu")
    assert ra.device.type == rgl.matrix.device.type == "cpu"
    assert jnp.asarray(ra.lambdas.numpy()).shape == (len(X),)
