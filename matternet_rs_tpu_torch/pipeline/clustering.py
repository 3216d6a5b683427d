"""Stage A: radius-gated incremental clustering with Welford variances
(twin of the reference's ``pipeline/clustering.py``).

Semantics of the staged generation: a row joins its nearest centroid when
the squared distance is under the radius, else creates a centroid while
the budget lasts, else is force-assigned to the nearest. The scan is the
native C++ one (``native/clustering.cpp``, ``mode="stage_a"``), with a
Python scan of identical decisions for hosts without g++. Each centroid's
Welford M2 gives its diagonal variance (0.1 for singletons). Above
``projection_threshold`` features the rows are JL-projected first
(:class:`..reduction.ImplicitProjection`), and stage D reuses them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from matternet_rs_tpu_torch import native as native_mod
from matternet_rs_tpu_torch.backend import resolve_device
from matternet_rs_tpu_torch.pipeline.centroid import CentroidState
from matternet_rs_tpu_torch.reduction import ImplicitProjection


def compute_jl_dimension(n_points: int, original_dim: int, epsilon: float) -> int:
    """``r = ⌈8·ln(n)/ε²⌉`` clamped to [32, F]."""
    jl_bound = math.ceil(8.0 * math.log(max(n_points, 1)) / (epsilon ** 2))
    return int(min(max(jl_bound, 32), original_dim))


@dataclasses.dataclass(frozen=True)
class ClusteringConfig:
    max_clusters: int = 10_000
    radius_threshold: float = 1.0     # squared L2
    seed: Optional[int] = 42
    use_projection: bool = True
    projection_threshold: int = 1000
    jl_epsilon: float = 0.3
    min_projected_dim: int = 64
    batch_size: int = 4096

    @classmethod
    def high_dimensional(cls) -> "ClusteringConfig":
        return cls(radius_threshold=1.5, min_projected_dim=128)


@dataclasses.dataclass
class ClusteringOutput:
    state: CentroidState
    assignments: np.ndarray           # [N] int, every row assigned
    num_items: int
    original_dim: int
    working_dim: int
    projection: Optional[ImplicitProjection]
    # The [N, working_dim] rows the scan ran on (the input when there is
    # no projection); stage D takes them as they are.
    working: Optional[np.ndarray] = None


class ClusteringStage:
    """``device``: where the centroid state and the projection live
    (``None`` is the CUDA card)."""

    def __init__(self, config: ClusteringConfig | None = None, device=None):
        self.config = config or ClusteringConfig()
        self.device = resolve_device(device)

    def execute(self, rows) -> ClusteringOutput:
        cfg = self.config
        X = np.asarray(rows, np.float32)
        n, f = X.shape
        projection, working, working_dim = None, X, f
        if cfg.use_projection and f > cfg.projection_threshold:
            jl_dim = compute_jl_dimension(n, f, cfg.jl_epsilon)
            working_dim = max(min(jl_dim, f // 2), cfg.min_projected_dim)
            projection = ImplicitProjection(f, working_dim, cfg.seed or 42)
            working = projection.project(X, self.device).cpu().numpy()

        cents, assignments, counts, m2 = self._incremental(working)
        var = np.where(counts[:, None] > 1, m2 / np.maximum(counts[:, None], 1),
                       0.1).astype(np.float32)
        dev = self.device
        state = CentroidState(
            means=torch.from_numpy(np.array(cents, np.float32)).to(dev),
            variances=torch.from_numpy(var).to(dev),
            counts=torch.from_numpy(counts.astype(np.int32)).to(dev),
        )
        return ClusteringOutput(state=state, assignments=assignments, num_items=n,
                                original_dim=f, working_dim=working_dim,
                                projection=projection, working=working)

    def _incremental(self, X: np.ndarray):
        """The native scan, else the Python scan (identical decisions:
        live centroids, the first nearest on ties, float64 online means)."""
        cfg = self.config
        cap = min(cfg.max_clusters, X.shape[0])
        out = native_mod.incremental_cluster(X, cap, cfg.radius_threshold, "stage_a")
        if out is not None:
            return out
        n, f = X.shape
        cents = np.zeros((cap, f), np.float64)
        m2 = np.zeros((cap, f), np.float64)
        counts = np.zeros(cap, np.int64)
        assignments = np.zeros(n, np.int64)
        ncent = 0

        def add_point(ci: int, row: np.ndarray):
            counts[ci] += 1
            delta = row - cents[ci]
            cents[ci] += delta / counts[ci]
            m2[ci] += delta * (row - cents[ci])

        def create(row: np.ndarray) -> int:
            nonlocal ncent
            cents[ncent] = row
            counts[ncent] = 1
            ncent += 1
            return ncent - 1

        assignments[0] = create(X[0].astype(np.float64))
        for i in range(1, n):
            row = X[i].astype(np.float64)
            d2 = np.sum((cents[:ncent] - row) ** 2, axis=1)
            bi = int(np.argmin(d2))
            if float(d2[bi]) < cfg.radius_threshold:
                add_point(bi, row)
                assignments[i] = bi
            elif ncent < cap:
                assignments[i] = create(row)
            else:
                add_point(bi, row)
                assignments[i] = bi
        return cents[:ncent].astype(np.float32), assignments, counts[:ncent].copy(), m2[:ncent]
