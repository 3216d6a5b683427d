"""The staged pipeline A → B0 → B1 → B2 → C → D (twin of the reference's
``pipeline/run.py``).

Stage A (the host clustering scan) gives the centroid state; B0–C run at
centroid scale on the device (with B1's tree walks and B2's recursion as
their modules say), and stage D scores every row — over a device mesh
with ``mesh=``. ``build`` runs on the CUDA card unless ``device="cpu"``.
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
    """Run the whole pipeline on ``[N, F]`` rows. With ``mesh`` (a
    :class:`..parallel.mesh.Mesh`) stage D, the only stage that grows with
    N, shards the rows over the mesh with the F×F Laplacian replicated
    (:func:`_compute_tau_mode_sharded`); the other stages run on
    ``device`` (default: the mesh's lead device).

    As in the reference, an MST that does not reach every centroid leaves
    the traversal order short of C, and mapping the items' centroids
    through it raises ``IndexError``."""
    cfg = config or PipelineConfig()
    dev = backend.resolve_device(mesh.lead if device is None and mesh is not None else device)
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
    if mesh is not None:
        lambdas = timed("D:spectral", _compute_tau_mode_sharded, mesh, lap, work)
    else:
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


def _compute_tau_mode_sharded(mesh, lap: LaplacianOutput, work) -> np.ndarray:
    """Stage D over a mesh: each slot takes the Rayleigh terms and edge
    energies of its rows against the replicated Laplacian; the row
    energies are gathered so the Dirichlet total is summed over the N real
    rows in one pass, in row order, as on one device. Returns λ ``[N]``
    float64."""
    import torch

    from matternet_rs_tpu_torch.parallel.mesh import (
        all_gather,
        local_map,
        replicate,
        shard_items,
    )

    n = work.shape[0]
    Xs = shard_items(mesh, torch.as_tensor(work, dtype=torch.float32))
    terms = local_map(mesh, lambda _, Xl, Ll: spectral.stage_d_terms(Ll, Xl), Xs,
                      replicate(mesh, lap.matrix.to(torch.float32)))
    rayleigh = all_gather(mesh, [t[0] for t in terms], tiled=True)[:n]
    row_sums = all_gather(mesh, [t[1] for t in terms], tiled=True)[:n]
    lam = rayleigh + torch.clamp(row_sums / (torch.sum(row_sums) + 1e-12), 0.0, 1.0)
    return lam.cpu().numpy().astype(np.float64)


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
