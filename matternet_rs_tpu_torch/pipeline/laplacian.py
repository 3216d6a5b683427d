"""Stage C: the feature-space Laplacian from smoothed centroids (twin of
the reference's ``pipeline/laplacian.py``).

The ``[F, C]`` feature profiles → pairwise Bhattacharyya distances
(tiled, :func:`..ops.distance.bhattacharyya_pairwise`) → coefficient
``exp(−D)``, self excluded, below-threshold edges dropped → each row's
top-k (:func:`..ops.search.topk_stable`, ties lowest index first) →
scatter-max into ``W`` → ``max(W, Wᵀ)`` → ``L = I − D^{-1/2} W D^{-1/2}``
on connected nodes, or ``L = D − W``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from matternet_rs_tpu_torch.ops import distance as dist_ops
from matternet_rs_tpu_torch.ops.search import topk_stable
from matternet_rs_tpu_torch.pipeline.centroid import CentroidState


@dataclasses.dataclass(frozen=True)
class LaplacianConfig:
    k_neighbors: int = 15
    variance_regularizer: float = 1e-6
    normalize: bool = True
    weight_threshold: float = 1e-9


@dataclasses.dataclass
class LaplacianOutput:
    matrix: torch.Tensor       # [F, F] dense (structurally sparse)
    n_features: int
    nnz: int
    degrees: np.ndarray        # [F]
    sparsity: float

    def summary(self) -> str:
        return (f"LaplacianOutput: F={self.n_features}, nnz={self.nnz}, "
                f"sparsity={self.sparsity * 100.0:.2f}%")


def stage_c(feat_means: torch.Tensor, feat_vars: torch.Tensor, reg: float, thr: float, k: int,
            normalize: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``(L, degrees)`` from ``[F, C]`` feature profiles."""
    f = feat_means.shape[0]
    bc = dist_ops.bhattacharyya_coefficient(
        dist_ops.bhattacharyya_pairwise(feat_means, feat_vars, var_floor=reg))
    ar = torch.arange(f, device=bc.device)
    bc[ar, ar] = -float("inf")
    bc = torch.where(bc > thr, bc, torch.full_like(bc, -float("inf")))
    w, idx = topk_stable(bc, min(k, f - 1))
    w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
    W = torch.zeros((f, f), dtype=feat_means.dtype, device=bc.device).scatter_reduce(
        1, idx, w, reduce="amax", include_self=True)
    W = torch.maximum(W, W.T)
    deg = torch.sum(W, dim=1)
    if normalize:
        connected = deg > thr
        inv_sqrt = torch.where(connected, 1.0 / torch.sqrt(torch.clamp(deg, min=1e-30)),
                               torch.zeros_like(deg))
        L = torch.diag(connected.to(W.dtype)) - W * inv_sqrt[:, None] * inv_sqrt[None, :]
    else:
        L = torch.diag(deg) - W
    return L, deg


class LaplacianStage:
    def __init__(self, config: LaplacianConfig | None = None):
        self.config = config or LaplacianConfig()

    def execute(self, state: CentroidState) -> LaplacianOutput:
        cfg = self.config
        feat_means = state.to_feature_nodes().contiguous()
        f = feat_means.shape[0]
        L, deg = stage_c(feat_means, state.get_feature_variances().contiguous(),
                         cfg.variance_regularizer, cfg.weight_threshold, int(cfg.k_neighbors),
                         bool(cfg.normalize))
        nnz = int(torch.sum(torch.abs(L) > 1e-9))
        return LaplacianOutput(matrix=L, n_features=int(f), nnz=nnz,
                               degrees=deg.cpu().numpy(), sparsity=1.0 - nnz / (f * f))
