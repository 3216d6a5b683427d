"""The single-host shard store of the port (``storage/shards.py`` and the
native read-ahead reader) against the reference's: byte-identical files,
each package reading the other's store, seeks by ``start_row``, the
native reader against the Python one, and ``read_rows`` bounds. Rows
compare bit for bit."""

import filecmp

import numpy as np
import pytest

from matternet_rs_tpu.storage import shards as jshards

from matternet_rs_tpu_torch import native
from matternet_rs_tpu_torch.storage import shards as tshards

ROWS = np.random.default_rng(0).normal(size=(1000, 24)).astype(np.float32)


def _blocks():
    """Irregular producer blocks of the same rows."""
    cuts = [0, 7, 300, 301, 999, 1000]
    return [ROWS[a:b] for a, b in zip(cuts, cuts[1:])]


@pytest.mark.parametrize("rows_per_shard", [300, 250, 1000, 4096])
@pytest.mark.parametrize("as_blocks", [False, True])
def test_shard_files_are_byte_identical(tmp_path, rows_per_shard, as_blocks):
    src = _blocks if as_blocks else (lambda: ROWS)
    mj = jshards.write_shards(src(), tmp_path / "j", rows_per_shard)
    mt = tshards.write_shards(src(), tmp_path / "t", rows_per_shard)
    assert mj == mt
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for n in names:
        assert filecmp.cmp(tmp_path / "j" / n, tmp_path / "t" / n, shallow=False), n
    # 250 divides 1000: no empty trailing shard.
    assert sum(s["rows"] for s in mt["shards"]) == 1000 and all(s["rows"] for s in mt["shards"])


@pytest.mark.parametrize("start_row", [0, 1, 299, 300, 650, 999, 1000, 1500])
@pytest.mark.parametrize("block_rows", [1, 128, 300, 5000])
def test_each_package_reads_the_other_store(tmp_path, start_row, block_rows):
    jshards.write_shards(ROWS, tmp_path / "j", 300)
    tshards.write_shards(ROWS, tmp_path / "t", 300)
    want = ROWS[start_row:]
    for reader in (tshards.stream_blocks(tmp_path / "j", block_rows, start_row),
                   jshards.stream_blocks(tmp_path / "t", block_rows, start_row)):
        blocks = list(reader)
        assert all(len(b) == block_rows for b in blocks[:-1])
        got = np.concatenate(blocks) if blocks else np.zeros((0, 24), np.float32)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("start_row", [0, 13, 300, 999])
def test_native_reader_against_the_python_reader(tmp_path, monkeypatch, start_row):
    m = tshards.write_shards(ROWS, tmp_path, 300)
    paths = [tmp_path / s["file"] for s in m["shards"]]
    fast = native.ShardReader(paths, 128, 24, start_row=start_row)
    with monkeypatch.context() as mp:           # no library: the Python reader
        mp.setattr(native, "get_shard_lib", lambda: None)
        slow = native.ShardReader(paths, 128, 24, start_row=start_row)
    assert fast.native and not slow.native
    a, b = list(fast), list(slow)
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    # An ended stream stays ended.
    with pytest.raises(StopIteration):
        next(fast)


def test_reader_rejects_a_negative_start(tmp_path):
    m = tshards.write_shards(ROWS, tmp_path, 300)
    with pytest.raises(ValueError, match="start_row"):
        native.ShardReader([tmp_path / s["file"] for s in m["shards"]], 8, 24, start_row=-1)


def test_read_rows_and_its_bounds(tmp_path):
    tshards.write_shards(ROWS, tmp_path, 300)
    ids = np.array([999, 0, 300, 299, 5, 5])
    assert np.array_equal(tshards.read_rows(tmp_path, ids), ROWS[ids])
    assert np.array_equal(tshards.read_rows(tmp_path, ids), jshards.read_rows(tmp_path, ids))
    assert tshards.read_rows(tmp_path, []).shape == (0, 24)
    for bad in ([1000], [-1]):
        with pytest.raises(IndexError, match="out of range"):
            tshards.read_rows(tmp_path, bad)
    with pytest.raises(ValueError, match="1-D"):
        tshards.read_rows(tmp_path, [[1, 2]])


def test_write_rejects_bad_blocks(tmp_path):
    with pytest.raises(ValueError, match="inconsistent"):
        tshards.write_shards([ROWS[:5], ROWS[:5, :3]], tmp_path / "a")
    with pytest.raises(ValueError, match=r"\[n, F\]"):
        tshards.write_shards([ROWS[0]], tmp_path / "b")


def test_distributed_half_waits_for_parallel(tmp_path):
    """The distributed half, which waited for the port of ``parallel/``:
    ``shard_items_from_store`` gives each slot its own rows, per slot as
    the reference's devices hold them, and ``distributed_build_from_store``
    builds the λ of ``ShardedArrowSpace.distributed_build`` on the same
    rows (equal: one route, one order)."""
    import torch

    from matternet_rs_tpu.parallel import make_mesh as jmake_mesh
    from matternet_rs_tpu_torch.graph import GraphParams
    from matternet_rs_tpu_torch.parallel import make_mesh
    from matternet_rs_tpu_torch.parallel.index import ShardedArrowSpace

    tshards.write_shards(ROWS, tmp_path, rows_per_shard=7)
    for d in (1, 3, 8):
        xs, n = tshards.shard_items_from_store(make_mesh(d, devices=["cpu"] * d), tmp_path)
        ref, n_ref = jshards.shard_items_from_store(jmake_mesh(d), tmp_path)
        assert n == n_ref == len(ROWS)
        ref_parts = sorted(ref.addressable_shards, key=lambda s: s.index[0].start or 0)
        for (_, got), want in zip(xs.local(), ref_parts):
            assert np.array_equal(got.numpy(), np.asarray(want.data))
    params = GraphParams(eps=1.0, k=3, topk=3, sparsity_check=False)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    sa = tshards.distributed_build_from_store(tmp_path, params, 4, mesh=mesh, radius=2.0,
                                              sample_block_rows=5)
    direct = ShardedArrowSpace.distributed_build([ROWS], params, 4, mesh=mesh, radius=2.0)
    assert torch.equal(sa.lambdas.gather(), direct.lambdas.gather())
    assert (sa.min_lambdas, sa.range_lambdas) == (direct.min_lambdas, direct.range_lambdas)


@pytest.mark.parametrize("native_lib", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("start_row", [0, 299, 950])
def test_read_into_fills_a_given_buffer(tmp_path, monkeypatch, native_lib, start_row):
    """``ShardReader.read_into`` copies each block into the caller's buffer
    (a staging buffer) and returns its rows, 0 at the end; the blocks are
    those of the iterator."""
    m = tshards.write_shards(ROWS, tmp_path, 300)
    paths = [tmp_path / s["file"] for s in m["shards"]]
    if not native_lib:
        monkeypatch.setattr(native, "get_shard_lib", lambda: None)
    reader = native.ShardReader(paths, 128, 24, start_row=start_row)
    assert reader.native == native_lib
    buf = np.full((128, 24), np.nan, np.float32)
    got = []
    while (rows := reader.read_into(buf)):
        got.append(buf[:rows].copy())
    assert reader.read_into(buf) == 0
    assert np.array_equal(np.concatenate(got), ROWS[start_row:])
    with pytest.raises(ValueError, match="C-contiguous"):
        native.ShardReader(paths, 128, 24).read_into(np.zeros((64, 24), np.float32))
