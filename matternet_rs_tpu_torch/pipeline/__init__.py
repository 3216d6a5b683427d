"""The staged pipeline A → B0 → B1 → B2 → C → D (twin of the reference's
``pipeline/``): stage A incremental clustering (+ JL), B0 preflight, B1
thickness-weighted MST skeleton, B2 Kalman RTS smoothing along the MST
order, C Bhattacharyya feature-space Laplacian, D batched spectral λ
(Rayleigh + Dirichlet)."""

from matternet_rs_tpu_torch.pipeline.centroid import CentroidState
from matternet_rs_tpu_torch.pipeline.clustering import ClusteringConfig, ClusteringStage
from matternet_rs_tpu_torch.pipeline.preflight import PreflightConfig, PreflightStage
from matternet_rs_tpu_torch.pipeline.mst import MSTConfig, MSTStage
from matternet_rs_tpu_torch.pipeline.smoothing import SmoothingConfig, SmoothingStage
from matternet_rs_tpu_torch.pipeline.laplacian import LaplacianConfig, LaplacianStage
from matternet_rs_tpu_torch.pipeline.spectral import compute_lambdas, compute_tau_mode
from matternet_rs_tpu_torch.pipeline.taumode import TauMode, compute_tau
from matternet_rs_tpu_torch.pipeline.run import PipelineConfig, PipelineResult, build

__all__ = [
    "CentroidState",
    "ClusteringConfig", "ClusteringStage",
    "PreflightConfig", "PreflightStage",
    "MSTConfig", "MSTStage",
    "SmoothingConfig", "SmoothingStage",
    "LaplacianConfig", "LaplacianStage",
    "compute_lambdas", "compute_tau_mode",
    "TauMode", "compute_tau",
    "PipelineConfig", "PipelineResult", "build",
]
