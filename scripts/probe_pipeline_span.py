#!/usr/bin/env python3
"""Probe the staged pipeline's graphs on ``make_gaussian_hd`` on the card.

    python3 scripts/probe_pipeline_span.py [n_rows]

For each stage-A cap (3,000 and the default 10,000) on
``make_gaussian_hd(n_rows, 0.3)`` (200,000 by default): stages A and B0
once, the thick centroids (mean variance > 1), the nodes the MST reaches
at candidate k = 8 (the reference's default), 16, 24 and 32; then
``pipeline.build`` at k = 32: C, the nodes reached, stage C's nnz and its
least Bhattacharyya distance between two features' profiles (an edge
needs it below ln 1e9), τ, and the λ range. One JSON line per cap, the
card's name and power limit first. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_pipeline_span: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from matternet_rs_tpu_torch import pipeline
    from matternet_rs_tpu_torch.ops import distance as dist
    from matternet_rs_tpu_torch.utils.fixtures import make_gaussian_hd

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    X = make_gaussian_hd(n, 0.3).astype(np.float32)
    for cap in (3_000, 10_000):
        t0 = time.perf_counter()
        a_out = pipeline.ClusteringStage(pipeline.ClusteringConfig(max_clusters=cap)).execute(X)
        b0 = pipeline.PreflightStage().execute(a_out.state)
        st = pipeline.CentroidState(b0.normalized_centroids, b0.variances, a_out.state.counts)
        thickness = st.get_thickness()
        reached = {k: pipeline.MSTStage(pipeline.MSTConfig(k_neighbors=k)).execute(st).nodes_in_mst
                   for k in (8, 16, 24, 32)}
        res = pipeline.build(X, pipeline.PipelineConfig(
            clustering=pipeline.ClusteringConfig(max_clusters=cap),
            mst=pipeline.MSTConfig(k_neighbors=32)))
        Df = dist.bhattacharyya_pairwise(res.state.to_feature_nodes().contiguous(),
                                         res.state.get_feature_variances().contiguous(),
                                         var_floor=pipeline.LaplacianConfig().variance_regularizer)
        Df.fill_diagonal_(float("inf"))
        print(json.dumps(dict(
            n=n, cap=cap, n_centroids=st.num_centroids,
            thick_centroids=int((thickness > 1.0).sum()), thickness_max=float(thickness.max()),
            nodes_in_mst_by_k=reached, build_k32=dict(
                nodes_in_mst=res.mst.nodes_in_mst, laplacian_nnz=res.laplacian.nnz,
                feature_pair_min_distance=float(Df.min()), tau=res.tau,
                lambda_range=[float(res.lambdas.min()), float(res.lambdas.max())],
                stage_seconds=res.timings),
            seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
