"""Command-line interface: build, search, serve and inspect indexes (twin
of the reference's ``__main__.py``, over the same artifacts: checkpoints
and stores written by either package are read by both).

Usage::

    python -m matternet_rs_tpu_torch build  data.npy --out idx_dir --name myidx \
        [--pipeline eigen|energy] [--eps 1.0] [--k 6] [--max-clusters 64] \
        [--radius 25.0] [--seed 42] [--dims-reduction] [--device cpu]
    python -m matternet_rs_tpu_torch search idx_dir --name myidx --query q.npy \
        [--k 10] [--alpha 0.7] [--device cpu]
    python -m matternet_rs_tpu_torch info   idx_dir --name myidx
    python -m matternet_rs_tpu_torch serve  idx_dir --name myidx [--port 8757] \
        [--device cpu]

Every subcommand that builds or loads an index runs on the CUDA card
unless ``--device cpu`` is given; without a card it fails. The mesh paths
(``build-distributed --n-devices D``, ``serve --streaming --mesh D``) take
D cards and fail with ``ValueError`` when fewer are visible; with
``--device cpu`` all D slots run on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _mesh(n: int | None, device):
    """The subcommand's mesh: ``n`` cards (default every visible card), or
    with ``--device cpu`` ``n`` slots on the CPU (default 1). Any CUDA
    spelling takes ``n`` distinct cards and raises when fewer are visible."""
    import torch

    from matternet_rs_tpu_torch.parallel import make_mesh

    if device is not None and torch.device(device).type == "cpu":
        n = n or 1
        return make_mesh(n, devices=[device] * n)
    return make_mesh(n)


def _load_matrix(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".parquet"):
        from matternet_rs_tpu_torch.storage import parquet as pq

        return pq.load_dense_matrix(path)
    raise SystemExit(f"unsupported input format: {path} (use .npy or .parquet)")


def cmd_build(args) -> None:
    from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder
    from matternet_rs_tpu_torch.storage import parquet as pq

    data = _load_matrix(args.data).astype(np.float32)
    b = (
        ArrowSpaceBuilder(device=args.device)
        .with_lambda_graph(args.eps, args.k)
        .with_sparsity_check(False)
        .with_seed(args.seed)
    )
    if args.max_clusters:
        b.with_cluster_params(max_clusters=args.max_clusters, radius=args.radius)
    if args.dims_reduction:
        b.with_dims_reduction(True)
    if args.sampling_rate is not None:
        b.with_sampling(("simple", args.sampling_rate))
    else:
        b.with_sampling(None)

    aspace, gl = b.build_for_persistence(data, pipeline=args.pipeline)
    pq.save_checkpoint(aspace, gl, b, args.out, args.name)
    print(json.dumps({
        "status": "built",
        "n_items": aspace.nitems,
        "n_features": aspace.nfeatures,
        "n_clusters": aspace.n_clusters,
        "pipeline": args.pipeline,
        "out": str(args.out),
        "name": args.name,
    }))


def cmd_search(args) -> None:
    from matternet_rs_tpu_torch import eigenmaps
    from matternet_rs_tpu_torch.storage import parquet as pq

    aspace, gl = pq.load_arrowspace(args.index_dir, args.name, device=args.device)
    q = _load_matrix(args.query).astype(np.float32)
    queries = q[None, :] if q.ndim == 1 else q
    results = []
    for row in queries:
        if gl.energy:
            from matternet_rs_tpu_torch import energymaps

            res = energymaps.search_energy(aspace, row, gl, args.k)
            results.append(
                [{"index": i, "distance": round(d, 6)} for i, d in res]
            )
        else:
            res = eigenmaps.search(aspace, row, gl, args.k, args.alpha)
            results.append([{"index": i, "score": round(s, 6)} for i, s in res])
    print(json.dumps({"results": results}))


def cmd_info(args) -> None:
    from pathlib import Path

    meta_path = Path(args.index_dir) / f"{args.name}-arrowspace_metadata.json"
    if not meta_path.exists():
        raise SystemExit(f"no metadata at {meta_path}")
    print(meta_path.read_text())


def cmd_serve(args) -> None:
    from matternet_rs_tpu_torch.serve import (
        IndexService,
        StreamingIndexService,
        serve,
    )

    if getattr(args, "streaming", False):
        if getattr(args, "energy_candidates", None):
            raise SystemExit(
                "--energy-candidates applies to stored (non-streaming) "
                "indexes; the streaming sketch service has its own "
                "candidate pool (see TUNING.md)"
            )
        mesh = _mesh(args.mesh, args.device) if getattr(args, "mesh", 0) else None
        service = StreamingIndexService.from_store(
            args.index_dir, device=args.device if mesh is None else mesh.lead,
            sketch=not args.no_sketch, mesh=mesh,
            batch_window_ms=args.batch_window_ms, max_batch=args.max_batch,
        )
    else:
        ec = getattr(args, "energy_candidates", None)
        if ec and ec != "auto":
            ec = int(ec)
        service = IndexService.from_storage(
            args.index_dir, args.name, device=args.device,
            energy_candidates=ec or None,
            batch_window_ms=args.batch_window_ms, max_batch=args.max_batch,
        )
    print(json.dumps({"serving": f"http://{args.host}:{args.port}",
                      **service.info()}), flush=True)
    serve(service, args.host, args.port)


def cmd_shard_write(args) -> None:
    from matternet_rs_tpu_torch.storage import shards as ss

    data = _load_matrix(args.data).astype(np.float32)
    manifest = ss.write_shards(data, args.out, rows_per_shard=args.rows_per_shard)
    print(json.dumps({"status": "sharded", "out": str(args.out), **manifest}))


def cmd_build_distributed(args) -> None:
    from matternet_rs_tpu_torch.graph import GraphParams
    from matternet_rs_tpu_torch.storage import shards as ss

    params = GraphParams(
        eps=args.eps, k=args.k, topk=min(args.k, 4), sparsity_check=False
    )
    sa = ss.distributed_build_from_store(
        args.store_dir, params, k_clusters=args.k_clusters,
        mesh=_mesh(args.n_devices, args.device), lloyd_iters=args.lloyd_iters,
        centroids=args.centroids, radius=args.cluster_radius,
        centroid_sample=args.centroid_sample,
    )
    info = {
        "status": "built",
        "n_items": sa.n_items,
        "n_devices": sa.mesh.size,
        "lambda_range": sa.range_lambdas,
    }
    if args.save_store:
        sa.to_store(args.save_store)
        info["saved_store"] = str(args.save_store)
    if args.query is not None:
        q = _load_matrix(args.query).astype(np.float32)
        q = q if q.ndim == 1 else q[0]
        info["query_top"] = [
            {"index": i, "score": round(s, 6)} for i, s in sa.search(q, k=args.topk)
        ]
    print(json.dumps(info))


def cmd_build_streaming(args) -> None:
    from matternet_rs_tpu_torch.graph import GraphParams
    from matternet_rs_tpu_torch.index.streaming import StreamingIndex

    params = GraphParams(
        eps=args.eps, k=args.k, topk=min(args.k, 4), sparsity_check=False
    )
    si = StreamingIndex.build_from_store(
        args.store_dir, params, max_clusters=args.max_clusters,
        radius=args.radius, block_rows=args.block_rows,
        sample_rows=args.sample_rows, resume=args.resume,
        emit_sketch=args.emit_sketch, device=args.device,
    )
    print(json.dumps({
        "status": "built",
        "n_items": si.n_items,
        "n_features": si.n_features,
        "block_rows": si.block_rows,
        "lambda_range": si.range_lambdas,
    }))


def cmd_search_streaming(args) -> None:
    from matternet_rs_tpu_torch.index.streaming import StreamingIndex

    si = StreamingIndex.load(args.store_dir, device=args.device)
    q = _load_matrix(args.query).astype(np.float32)
    queries = q[None, :] if q.ndim == 1 else q
    sketch = getattr(args, "sketch", False)
    if si.sub_centroids is not None:      # energy-mode store
        if sketch:
            idx, sc = si.search_energy_batch_sketch(queries, args.k)
        else:
            idx, sc = si.search_energy_batch(queries, args.k)
        key = "distance"
    elif sketch:
        idx, sc = si.search_batch_sketch(queries, args.k, args.alpha)
        key = "score"
    else:
        idx, sc = si.search_batch(queries, args.k, args.alpha)
        key = "score"
    print(json.dumps({
        "results": [
            [{"index": int(i), key: round(float(s), 6)}
             for i, s in zip(ri, rs)]
            for ri, rs in zip(idx, sc)
        ]
    }))


def _device_option(parser) -> None:
    parser.add_argument(
        "--device", default=None, metavar="DEV",
        help="where the index is built or loaded: the CUDA card by default "
             "(failing without one), or 'cpu'",
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="matternet_rs_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pb = sub.add_parser("build", help="build an index from a data matrix")
    pb.add_argument("data")
    pb.add_argument("--out", required=True)
    pb.add_argument("--name", default="index")
    pb.add_argument("--pipeline", choices=["eigen", "energy"], default="eigen")
    pb.add_argument("--eps", type=float, default=1.0)
    pb.add_argument("--k", type=int, default=6)
    pb.add_argument("--max-clusters", type=int, default=None)
    pb.add_argument("--radius", type=float, default=1.0)
    pb.add_argument("--seed", type=int, default=42)
    pb.add_argument("--dims-reduction", action="store_true")
    pb.add_argument("--sampling-rate", type=float, default=None)
    _device_option(pb)
    pb.set_defaults(fn=cmd_build)

    ps = sub.add_parser("search", help="query a stored index")
    ps.add_argument("index_dir")
    ps.add_argument("--name", default="index")
    ps.add_argument("--query", required=True)
    ps.add_argument("--k", type=int, default=10)
    ps.add_argument("--alpha", type=float, default=0.7)
    _device_option(ps)
    ps.set_defaults(fn=cmd_search)

    pi = sub.add_parser("info", help="print index metadata")
    pi.add_argument("index_dir")
    pi.add_argument("--name", default="index")
    pi.set_defaults(fn=cmd_info)

    pv = sub.add_parser("serve", help="serve a stored index over HTTP")
    pv.add_argument("index_dir")
    pv.add_argument("--name", default="index")
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8757)
    pv.add_argument(
        "--streaming", action="store_true",
        help="index_dir is a shard store (out-of-core index); serve via "
             "the device-resident sketch",
    )
    pv.add_argument(
        "--no-sketch", action="store_true",
        help="with --streaming: exact streamed scan instead of the sketch",
    )
    pv.add_argument(
        "--mesh", type=int, default=0, metavar="D",
        help="with --streaming: shard the sketch over a D-device mesh "
             "(sketches bigger than one chip's HBM)",
    )
    pv.add_argument(
        "--energy-candidates", default=None, metavar="C",
        help="banded two-stage /search_energy dispatch: window size C or "
             "'auto' (falls back to the full scan on tie-dense corpora "
             "or when the windows would gather >N/10 rows per batch)",
    )
    pv.add_argument(
        "--max-batch", type=int, default=256, metavar="B",
        help="micro-batcher dispatch cap (default 256; raise to 1024 for "
             "throughput-dominated loads — device QPS keeps scaling with "
             "batch on the compute-bound scan, see TUNING.md)",
    )
    pv.add_argument(
        "--batch-window-ms", type=float, default=2.0, metavar="MS",
        help="micro-batcher collection window (latency floor under "
             "sparse traffic)",
    )
    _device_option(pv)
    pv.set_defaults(fn=cmd_serve)

    pw = sub.add_parser(
        "shard-write", help="write a matrix into the raw shard store"
    )
    pw.add_argument("data")
    pw.add_argument("--out", required=True)
    pw.add_argument("--rows-per-shard", type=int, default=262_144)
    pw.set_defaults(fn=cmd_shard_write)

    pd = sub.add_parser(
        "build-distributed",
        help="mesh-distributed build streamed from a shard store",
    )
    pd.add_argument("store_dir")
    pd.add_argument("--k-clusters", type=int, default=64)
    pd.add_argument("--eps", type=float, default=1.0)
    pd.add_argument("--k", type=int, default=6)
    pd.add_argument("--n-devices", type=int, default=None)
    pd.add_argument("--lloyd-iters", type=int, default=10)
    pd.add_argument(
        "--centroids", choices=["serial", "lloyd"], default="serial",
        help="stage-1 semantics: 'serial' = exact serial-builder parity "
             "(host-streamed sample), 'lloyd' = mesh-reduced scale escape",
    )
    pd.add_argument("--cluster-radius", type=float, default=25.0)
    pd.add_argument(
        "--centroid-sample", type=int, default=None,
        help="bound the host-side serial-clustering sample (default: all "
             "rows — exact parity with the serial builder)",
    )
    pd.add_argument("--query", default=None, help=".npy query to run after build")
    pd.add_argument("--topk", type=int, default=10)
    pd.add_argument(
        "--save-store", default=None,
        help="persist the built index to this directory (unified store: "
             "resumable via load_from_store / StreamingIndex / "
             "search-streaming)",
    )
    _device_option(pd)
    pd.set_defaults(fn=cmd_build_distributed)

    pbs = sub.add_parser(
        "build-streaming",
        help="out-of-core single-chip index over a shard store",
    )
    pbs.add_argument("store_dir")
    pbs.add_argument("--max-clusters", type=int, default=64)
    pbs.add_argument("--radius", type=float, default=25.0)
    pbs.add_argument("--eps", type=float, default=1.0)
    pbs.add_argument("--k", type=int, default=6)
    pbs.add_argument("--block-rows", type=int, default=131_072)
    pbs.add_argument("--sample-rows", type=int, default=200_000)
    pbs.add_argument(
        "--resume", action="store_true",
        help="pick up an interrupted lambda pass from the last whole "
             "block (seeks past completed rows without re-reading them)",
    )
    pbs.add_argument(
        "--emit-sketch", action="store_true",
        help="write sketch.bin/sketch_meta.npz during the lambda pass "
             "(no extra corpus IO) so sketch serving warms from the "
             "1-byte/elem file",
    )
    _device_option(pbs)
    pbs.set_defaults(fn=cmd_build_streaming)

    pss = sub.add_parser(
        "search-streaming", help="streamed exact query over an out-of-core index"
    )
    pss.add_argument("store_dir")
    pss.add_argument("--query", required=True)
    pss.add_argument("--k", type=int, default=10)
    pss.add_argument("--alpha", type=float, default=0.7)
    pss.add_argument(
        "--sketch", action="store_true",
        help="scan the device-resident int8 sketch (exact disk rescore) "
             "instead of restreaming the corpus; works for blended AND "
             "energy-mode stores",
    )
    _device_option(pss)
    pss.set_defaults(fn=cmd_search_streaming)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
