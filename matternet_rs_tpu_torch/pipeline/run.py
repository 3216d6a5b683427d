"""The staged pipeline A → B0 → B1 → B2 → C → D (twin of the reference's
``pipeline/run.py``).

Stage A (the host clustering scan) gives the centroid state; B0–C run at
centroid scale on the device (with B1's tree walks and B2's recursion as
their modules say), and stage D scores every row. ``build`` runs on the
CUDA card unless ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np

from matternet_rs_tpu_torch import backend
from matternet_rs_tpu_torch.pipeline import spectral
from matternet_rs_tpu_torch.pipeline.centroid import CentroidState
from matternet_rs_tpu_torch.pipeline.clustering import ClusteringConfig, ClusteringStage
from matternet_rs_tpu_torch.pipeline.laplacian import (
    LaplacianConfig,
    LaplacianOutput,
    LaplacianStage,
)
from matternet_rs_tpu_torch.pipeline.mst import MSTConfig, MSTOutput, MSTStage
from matternet_rs_tpu_torch.pipeline.preflight import PreflightConfig, PreflightStage
from matternet_rs_tpu_torch.pipeline.smoothing import KalmanOutput, SmoothingConfig, SmoothingStage
from matternet_rs_tpu_torch.pipeline.taumode import TauMode, compute_tau

log = logging.getLogger(__name__)


@dataclasses.dataclass
class PipelineConfig:
    clustering: ClusteringConfig = dataclasses.field(default_factory=ClusteringConfig)
    preflight: PreflightConfig = dataclasses.field(default_factory=PreflightConfig)
    mst: MSTConfig = dataclasses.field(default_factory=MSTConfig)
    smoothing: SmoothingConfig = dataclasses.field(default_factory=SmoothingConfig)
    laplacian: LaplacianConfig = dataclasses.field(default_factory=LaplacianConfig)
    taumode: TauMode = dataclasses.field(default_factory=TauMode.median)


@dataclasses.dataclass
class PipelineResult:
    state: CentroidState                 # smoothed centroid state (B2), rows in MST order
    # [N] item → its stage-A centroid id. Rows of `state` are in MST order
    # (row t ↔ centroid kalman.order[t]): index `state` with
    # `centroid_positions`, not `assignments`.
    assignments: np.ndarray
    # [N] item → row of `state` holding its smoothed centroid.
    centroid_positions: np.ndarray
    mst: MSTOutput
    kalman: KalmanOutput
    laplacian: LaplacianOutput
    lambdas: np.ndarray                  # [N] stage-D λ
    tau: float                           # τ of the λ distribution
    timings: dict[str, float]


def build(rows, config: Optional[PipelineConfig] = None, mesh=None,
          device=None) -> PipelineResult:
    """Run the whole pipeline on ``[N, F]`` rows. ``mesh`` (the reference
    shards stage D over a device mesh) raises ``NotImplementedError``
    until ``parallel/`` is ported (ROADMAP Queue 1 item 5).

    As in the reference, an MST that does not reach every centroid leaves
    the traversal order short of C, and mapping the items' centroids
    through it raises ``IndexError``."""
    if mesh is not None:
        raise NotImplementedError(
            "pipeline.build(mesh=...) shards stage D over a device mesh, which waits for "
            "the port of parallel/ (ROADMAP Queue 1 item 5)"
        )
    cfg = config or PipelineConfig()
    dev = backend.resolve_device(device)
    X = np.asarray(rows, np.float32)
    timings: dict[str, float] = {}
    backend.print_backend_info()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        if dev.type == "cuda":
            import torch

            torch.cuda.synchronize(dev)
        timings[name] = time.perf_counter() - t0
        log.info("stage %s: %.3fs", name, timings[name])
        return out

    a_out = timed("A:clustering", ClusteringStage(cfg.clustering, dev).execute, X)
    b0 = timed("B0:preflight", PreflightStage(cfg.preflight).execute, a_out.state)
    state = CentroidState(means=b0.normalized_centroids, variances=b0.variances,
                          counts=a_out.state.counts)
    mst = timed("B1:mst", MSTStage(cfg.mst).execute, state)
    kalman = timed("B2:kalman", SmoothingStage(cfg.smoothing).execute, state, mst)
    smoothed = kalman.to_centroid_state()
    lap = timed("C:laplacian", LaplacianStage(cfg.laplacian).execute, smoothed)
    # Stage D on the rows stage A clustered (projected, if it projected).
    work = a_out.working if a_out.working is not None else X
    lambdas = timed("D:spectral", spectral.compute_tau_mode, lap, work,
                    work.shape[0], work.shape[1])
    tau = compute_tau(lambdas, cfg.taumode)

    # Stage-A centroid ids → rows of the MST-ordered smoothed state.
    order = np.asarray(kalman.order, np.int64)
    pos_of = np.empty_like(order)
    pos_of[order] = np.arange(len(order))
    return PipelineResult(
        state=smoothed, assignments=a_out.assignments,
        centroid_positions=pos_of[np.asarray(a_out.assignments, np.int64)],
        mst=mst, kalman=kalman, laplacian=lap, lambdas=lambdas, tau=tau, timings=timings,
    )


def save_result(result: PipelineResult, path, name: str = "pipeline") -> None:
    """Write the centroid state, the Laplacian, λ and the MST order as
    Parquet files (float64 columns)."""
    from matternet_rs_tpu_torch.storage import parquet as pq

    pq.save_dense_matrix(result.state.means.cpu().numpy(), path, f"{name}-means")
    pq.save_dense_matrix(result.state.variances.cpu().numpy(), path, f"{name}-variances")
    pq.save_sparse_matrix(result.laplacian.matrix.cpu().numpy(), path, f"{name}-laplacian")
    pq.save_lambdas(result.lambdas, path, f"{name}-lambdas")
    pq.save_dense_matrix(result.mst.centroid_order[:, None].astype(np.float64), path,
                         f"{name}-order")


def load_result_arrays(path, name: str = "pipeline") -> dict:
    """The files of :func:`save_result` back as numpy arrays."""
    from matternet_rs_tpu_torch.storage import parquet as pq

    base = Path(path)
    return {
        "means": pq.load_dense_matrix(base / f"{name}-means.parquet"),
        "variances": pq.load_dense_matrix(base / f"{name}-variances.parquet"),
        "laplacian": pq.load_sparse_matrix(base / f"{name}-laplacian.parquet"),
        "lambdas": pq.load_lambdas(base / f"{name}-lambdas.parquet"),
        "order": pq.load_dense_matrix(base / f"{name}-order.parquet")[:, 0].astype(int),
    }
