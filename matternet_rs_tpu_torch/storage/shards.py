"""Raw shard store (twin of the reference's ``storage/shards.py``): a
corpus as raw float32 shard files plus a JSON manifest, streamed in
fixed-size row blocks by the native read-ahead reader
(:class:`..native.ShardReader`), so at most two blocks sit on the host
whatever N is. The files are byte for byte the reference's for the same
input, and each package reads the other's store.

The distributed half places a store over a device mesh, each slot reading
its own row range (:func:`shard_items_from_store`), and builds the mesh
index from it (:func:`distributed_build_from_store`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable

import numpy as np

MANIFEST = "shards.json"


def write_shards(blocks: Iterable[np.ndarray] | np.ndarray, directory,
                 rows_per_shard: int = 262_144) -> dict:
    """Write ``[*, F]`` float32 rows (one array or an iterable of blocks)
    as shard files of ``rows_per_shard`` rows plus the manifest; returns
    the manifest."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    if isinstance(blocks, np.ndarray):
        blocks = [blocks]

    shard_rows: list[int] = []
    f_dim: int | None = None
    cur = None
    cur_rows = 0
    shard_idx = 0

    def open_next():
        nonlocal cur, cur_rows, shard_idx
        cur = open(directory / f"shard-{shard_idx:05d}.bin", "wb")
        cur_rows = 0
        shard_idx += 1

    open_next()
    for block in blocks:
        block = np.ascontiguousarray(block, np.float32)
        if block.ndim != 2:
            raise ValueError("blocks must be [n, F]")
        if f_dim is None:
            f_dim = int(block.shape[1])
        elif block.shape[1] != f_dim:
            raise ValueError("inconsistent feature dims across blocks")
        pos = 0
        while pos < len(block):
            take = min(rows_per_shard - cur_rows, len(block) - pos)
            cur.write(block[pos : pos + take].tobytes())
            cur_rows += take
            pos += take
            if cur_rows == rows_per_shard:
                cur.close()
                shard_rows.append(cur_rows)
                open_next()
    cur.close()
    if cur_rows:
        shard_rows.append(cur_rows)
    else:                                   # the trailing file is empty
        (directory / f"shard-{shard_idx - 1:05d}.bin").unlink()

    manifest = {
        "n_rows": int(sum(shard_rows)),
        "n_features": int(f_dim or 0),
        "dtype": "float32",
        "shards": [{"file": f"shard-{i:05d}.bin", "rows": int(r)}
                   for i, r in enumerate(shard_rows)],
    }
    (directory / MANIFEST).write_text(json.dumps(manifest, indent=1))
    return manifest


def read_manifest(directory) -> dict:
    return json.loads((Path(directory) / MANIFEST).read_text())


def stream_blocks(directory, block_rows: int, start_row: int = 0):
    """Iterate ``[block_rows, F]`` float32 blocks over every shard in
    order (the last may be shorter), from ``start_row`` rows in (a seek:
    skipped files are not read)."""
    from matternet_rs_tpu_torch.native import ShardReader

    directory = Path(directory)
    m = read_manifest(directory)
    paths = [directory / s["file"] for s in m["shards"]]
    return ShardReader(paths, block_rows, m["n_features"], start_row=start_row)


class RowReader:
    """Rows by global id from a store, through read-only maps of its shard
    files opened once: a reader kept across calls faults each page in on
    its first read only (the store must not be rewritten under it)."""

    def __init__(self, directory):
        directory = Path(directory)
        m = read_manifest(directory)
        self.n_rows, self.n_features = m["n_rows"], m["n_features"]
        self.starts = np.cumsum([0] + [s["rows"] for s in m["shards"]])
        self.maps = [np.memmap(directory / s["file"], np.float32, "r").reshape(-1, self.n_features)
                     for s in m["shards"]]

    def rows(self, row_ids) -> np.ndarray:
        """``[len(ids), F]`` float32 rows in the order given: the ids
        grouped by shard (already so when sorted), one ``np.take`` of whole
        rows per shard that holds one. ``IndexError`` for an id outside
        ``[0, n_rows)``."""
        ids = np.asarray(row_ids, np.int64)
        if ids.ndim != 1:
            raise ValueError("row_ids must be 1-D")
        if len(ids) == 0:
            return np.zeros((0, self.n_features), np.float32)
        if ids.min() < 0 or ids.max() >= self.n_rows:
            raise IndexError(
                f"row id out of range [0, {self.n_rows}): [{ids.min()}, {ids.max()}]"
            )
        shard_of = np.searchsorted(self.starts, ids, side="right") - 1
        order = np.argsort(shard_of, kind="stable")
        local = ids[order] - self.starts[shard_of[order]]
        cuts = np.searchsorted(shard_of[order], np.arange(len(self.maps) + 1))
        out = np.empty((len(ids), self.n_features), np.float32)
        for si, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
            if hi > lo:
                np.take(self.maps[si], local[lo:hi], axis=0, out=out[lo:hi])
        if np.any(order[1:] < order[:-1]):                # back to the order given
            back = np.empty_like(order)
            back[order] = np.arange(len(order))
            out = out[back]
        return out


def read_rows(directory, row_ids) -> np.ndarray:
    """Rows by global id, ``[len(ids), F]`` float32 in the order given
    (:meth:`RowReader.rows` through maps opened for this call).
    ``IndexError`` for an id outside ``[0, n_rows)``."""
    return RowReader(directory).rows(row_ids)


def shard_items_from_store(mesh, directory):
    """The mesh-sharded ``[N_pad, F]`` rows of a store: each of this
    process's slots reads its own global row range (a seek; a slot past
    ``n`` gets zeros), so at most one slot's block and the reader's
    read-ahead sit on the host. Returns ``(ShardedArray, n)``."""
    import torch

    from matternet_rs_tpu_torch.parallel.mesh import ShardedArray

    m = read_manifest(directory)
    n, f = m["n_rows"], m["n_features"]
    d = mesh.size
    n_pad = n + ((-n) % d)
    per = n_pad // d
    shards = [None] * d
    devs = mesh.slot_devices
    for i in mesh.local_slots:
        start = i * per
        take = max(0, min(per, n - start))
        block = np.zeros((per, f), np.float32)
        if take:
            reader = stream_blocks(directory, per, start_row=start)
            try:
                reader.read_into(block)          # stops at n: rows past it stay 0
            finally:
                reader.close()
        shards[i] = torch.from_numpy(block).to(devs[i])
    return ShardedArray(mesh, shards, (n_pad, f)), n


def distributed_build_from_store(directory, graph_params, k_clusters: int, taumode=None,
                                 n_devices: int | None = None, mesh=None, lloyd_iters: int = 10,
                                 centroids: str = "serial", radius: float = 25.0,
                                 centroid_sample: int | None = None,
                                 sample_block_rows: int = 65536):
    """The distributed build streamed from a store, with
    ``ShardedArrowSpace.distributed_build``'s stage-1 choices and defaults
    (so the two builds give the same λ on the same rows): ``"serial"`` the
    serial builder's scan over the first ``centroid_sample`` rows streamed
    in store order (default all: the sample is held on the host for stage
    1 only), ``"lloyd"`` the mesh-reduced Lloyd."""
    from matternet_rs_tpu_torch.core import TAUDEFAULT
    from matternet_rs_tpu_torch.parallel.index import build_from_rows
    from matternet_rs_tpu_torch.parallel.mesh import make_mesh

    mesh = mesh if mesh is not None else make_mesh(n_devices)
    Xs, n = shard_items_from_store(mesh, directory)

    def sample_blocks():
        reader = stream_blocks(directory, sample_block_rows)
        try:
            yield from reader
        finally:
            reader.close()

    return build_from_rows(mesh, Xs, n, graph_params, k_clusters, taumode or TAUDEFAULT,
                           lloyd_iters, centroids, radius, centroid_sample, sample_blocks)
