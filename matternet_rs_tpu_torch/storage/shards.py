"""Raw shard store, single-host half (twin of the reference's
``storage/shards.py``): a corpus as raw float32 shard files plus a JSON
manifest, streamed in fixed-size row blocks by the native read-ahead reader
(:class:`..native.ShardReader`), so at most two blocks sit on the host
whatever N is. The files are byte for byte the reference's for the same
input, and each package reads the other's store.

The mesh-sharded assembly and the distributed build from a store wait for
the port of ``parallel/`` (``backend.PARALLEL_PENDING``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable

import numpy as np

from matternet_rs_tpu_torch.backend import PARALLEL_PENDING

MANIFEST = "shards.json"
DISTRIBUTED_PENDING = f"the distributed build from a shard store {PARALLEL_PENDING}"


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


def read_rows(directory, row_ids) -> np.ndarray:
    """Rows by global id, ``[len(ids), F]`` float32 in the order given: one
    memmap and one gather per shard that holds a requested row.
    ``IndexError`` for an id outside ``[0, n_rows)``."""
    directory = Path(directory)
    m = read_manifest(directory)
    f = m["n_features"]
    ids = np.asarray(row_ids, np.int64)
    if ids.ndim != 1:
        raise ValueError("row_ids must be 1-D")
    if len(ids) == 0:
        return np.zeros((0, f), np.float32)
    if ids.min() < 0 or ids.max() >= m["n_rows"]:
        raise IndexError(
            f"row id out of range [0, {m['n_rows']}): [{ids.min()}, {ids.max()}]"
        )
    starts = np.cumsum([0] + [s["rows"] for s in m["shards"]])
    out = np.empty((len(ids), f), np.float32)
    shard_of = np.searchsorted(starts, ids, side="right") - 1
    for si in np.unique(shard_of):
        sel = shard_of == si
        mm = np.memmap(directory / m["shards"][si]["file"], np.float32, "r").reshape(-1, f)
        out[sel] = mm[ids[sel] - starts[si]]
    return out


def shard_items_from_store(mesh, directory):
    """Mesh-sharded assembly of a store: not ported yet."""
    raise NotImplementedError(DISTRIBUTED_PENDING)


def distributed_build_from_store(directory, graph_params, k_clusters: int, taumode=None,
                                 n_devices: int | None = None, mesh=None, lloyd_iters: int = 10,
                                 centroids: str = "serial", radius: float = 25.0,
                                 centroid_sample: int | None = None,
                                 sample_block_rows: int = 65536):
    """The distributed build streamed from a store: not ported yet."""
    raise NotImplementedError(DISTRIBUTED_PENDING)
