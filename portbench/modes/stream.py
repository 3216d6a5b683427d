"""``stream``: the out-of-core streaming index with its resident int8
sketch. The build writes the corpus as a shard store in a fresh directory
under the checkout's ``.portbench_cache/``, builds the index from the
store (the sample's clustering scan, the graph, the λ pass that also
writes the sketch) and uploads the sketch; the f32 rows stay in the
store, read back per batch for the refine. ``state`` keeps what the
comparison reads (λ, the sample's assignments, the graph, the sketch's
codes and multipliers, still on the card) and deletes the store; so does
the process's exit if the run dies first, and a build that fails.

The reference (``reference/streaming.py``) works every stage out again
from the corpus drawn anew, and the window's refined answers are judged
against its float64 scores of every row."""

from __future__ import annotations

import atexit
import dataclasses
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench.harness import check
from portbench.reference import clustering
from portbench.reference.streaming import StreamIndex

CACHE = Path(__file__).resolve().parents[2] / ".portbench_cache"
HOST_BLOCK = 1 << 20                 # rows copied to the host and written at a time


def disk_bytes(n: int, f: int) -> int:
    """The store's disk at ``n × f``: the f32 rows, the int8 sketch and its
    tmp file, λ and multipliers, 5% and 256 MB spare."""
    return int(n * (4 * f + f + 8) * 1.05) + (256 << 20)


def _remove(path: Path) -> None:
    shutil.rmtree(path, ignore_errors=True)


def _flush(path: Path) -> None:
    """Every file of the store written through to the disk, as a store
    built ahead of serving is: the window then races no write-back of the
    build's 4.8 GB (the pages stay cached, so the refine's reads are warm)."""
    for p in path.iterdir():
        fd = os.open(p, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def build(cfg: dict, X: torch.Tensor):
    """``(index, its graph, stage seconds)`` over ``X`` (a float32 tensor):
    the store written from host copies of ``X``'s row blocks, the index
    built from it on ``X``'s device, the sketch uploaded, the store flushed
    to the disk. Fails before
    writing anything where the disk lacks room (the rows are never cut),
    or where the program's index keeps no assignments of its sample."""
    from matternet_rs_tpu_torch.graph import GraphParams
    from matternet_rs_tpu_torch.index.streaming import StreamingIndex
    from matternet_rs_tpu_torch.storage import shards

    if "cluster_assignments" not in {fd.name for fd in dataclasses.fields(StreamingIndex)}:
        raise RuntimeError("stream: this program's StreamingIndex keeps no assignments of the "
                           "sampled rows (cluster_assignments), which the comparison reads")
    n, f = X.shape
    b, st = cfg["builder"], cfg["store"]
    CACHE.mkdir(parents=True, exist_ok=True)
    need, free = disk_bytes(n, f), shutil.disk_usage(CACHE).free
    if free < need:
        raise RuntimeError(f"stream: the store of {n:,} x {f} rows needs {need:,} bytes of disk "
                           f"under {CACHE}; {free:,} are free")
    store = Path(tempfile.mkdtemp(prefix="stream-", dir=CACHE))
    atexit.register(_remove, store)
    try:
        t0 = time.perf_counter()
        shards.write_shards((X[s:s + HOST_BLOCK].cpu().numpy() for s in range(0, n, HOST_BLOCK)),
                            store, rows_per_shard=int(st["rows_per_shard"]))
        t1 = time.perf_counter()
        eps, k = b["lambda_graph"]
        idx = StreamingIndex.build_from_store(
            store, GraphParams(eps=float(eps), k=int(k), topk=int(cfg["graph"]["topk"]),
                               sparsity_check=bool(b["sparsity_check"])),
            max_clusters=int(b["max_clusters"]), radius=float(b["radius"]),
            block_rows=int(st["block_rows"]), sample_rows=int(st["sample_rows"]),
            emit_sketch=True, device=X.device)
        t2 = time.perf_counter()
        idx.build_sketch()
        t3 = time.perf_counter()
        _flush(store)
        t4 = time.perf_counter()
    except BaseException:
        _remove(store)
        raise
    return idx, idx.gl, {"store_write_s": t1 - t0, **idx.build_timings,
                         "build_from_store_s": t2 - t1, "sketch_upload_s": t3 - t2,
                         "store_flush_s": t4 - t3}


def state(cfg: dict, aspace, gl) -> dict:
    """What the comparison reads from the program, kept before it is freed;
    then the store goes."""
    from matternet_rs_tpu_torch.index.streaming import LAMBDA_FILE

    n, f = aspace.n_items, aspace.n_features
    try:
        raw = torch.from_numpy(np.fromfile(aspace.directory / LAMBDA_FILE, np.float32, count=n))
        X8s, mults, _, _ = aspace._sketch
        out = {"lambdas": torch.clamp((raw - float(aspace.min_lambdas))
                                      / float(aspace.range_lambdas), 0.0, 1.0),
               "assignments": np.asarray(aspace.cluster_assignments).copy(),
               "centroids": gl.init_data.T.detach().clone(),
               "laplacian": gl.dense().detach().clone(),
               "codes": X8s.reshape(-1, f)[:n], "mults": mults.reshape(-1)[:n]}
    finally:
        _remove(Path(aspace.directory))
    return out


def reference(cfg: dict, X: torch.Tensor, prog: dict | None, prec: str = "f64") -> StreamIndex:
    """The reference over ``X``; ``prog`` (the program's state) settles the
    choices within rounding, ``prec="tf32"`` makes the control."""
    return StreamIndex(X, cfg, prec, follow=prog)


def reference_state(ref: StreamIndex) -> dict:
    """The control's state, in the program's place."""
    codes, mults = ref.sketch()
    return {"lambdas": ref.lambdas.float(), "assignments": ref.clustering.assignments,
            "centroids": ref.clustering.centroids.float(), "codes": codes, "mults": mults}


def answers(ref: StreamIndex, traffic: dict, pool: np.ndarray) -> list:
    """The reference's own top-k of every pool query (the control's)."""
    Qp, k, out = torch.from_numpy(pool).to(ref.X.device), int(traffic["k"]), []
    for q0 in range(0, len(pool), ref.query_block):
        v, i = torch.topk(ref.scores(Qp[q0:q0 + ref.query_block], float(traffic["alpha"])), k,
                          dim=1)
        out.append((np.arange(q0, q0 + len(v)), i.cpu().numpy(), v.double().cpu().numpy()))
    return out


def judge(cfg: dict, traffic: dict, ref: StreamIndex, prog: dict, pool: np.ndarray, win):
    """``(readings, extra)``: the window's refined answers, every row's λ,
    the sample's assignments and centroids, the sketch's codes and
    multipliers, against the reference."""
    Qp = torch.from_numpy(pool).to(ref.X.device)
    alpha = float(traffic["alpha"])
    readings = check.judge_answers(lambda a, b: ref.scores(Qp[a:b], alpha), ref.X.shape[0],
                                   win.answers, int(traffic["k"]), block=ref.query_block)
    readings["item_lambda_err"] = float(
        (prog["lambdas"].to(ref.lambdas.device).double() - ref.lambdas.double()).abs().max())
    readings.update(clustering.readings(ref.clustering, prog["assignments"], prog["centroids"]))
    sk = ref.sketch_readings(prog["codes"], prog["mults"])
    code_ties = sk.pop("code_ties")
    readings.update(sk)
    return readings, {"ambiguous_rows": ref.clustering.ambiguous,
                      "centroids": len(ref.clustering.centroids), "graph_ties": ref.graph_ties,
                      "code_ties": code_ties}
