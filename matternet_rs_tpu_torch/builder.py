"""ArrowSpaceBuilder: the fluent eigen-build API (twin of the reference's
``builder.py``).

``build`` runs: incremental clustering (host C++) → feature-space
Laplacian from the centroids (ELL-backed from 8192 features) → taumode λ
(kernel A from 32768 rows; the sparse ELL route beyond 2048 features) →
normalisation → sorted-λ index, all on the builder's device.

Not ported yet, and raising ``NotImplementedError``: the optimal-k
heuristics (``compute_optimal_k``, k-means++ on ``jax.random``) — set
``with_cluster_params(max_clusters=...)``; the JL projection
(``with_dims_reduction(True)``, its matrix comes from ``jax.random``);
persistence (``with_persistence``). ROADMAP.md Queue 1 item 5 carries them.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np

from matternet_rs_tpu_torch import clustering as clus
from matternet_rs_tpu_torch import eigenmaps as em
from matternet_rs_tpu_torch.backend import resolve_device
from matternet_rs_tpu_torch.core import TAUDEFAULT, ArrowSpace, TauMode
from matternet_rs_tpu_torch.graph import GraphLaplacian, GraphParams
from matternet_rs_tpu_torch.sampling import InlineSampler, make_sampler
from matternet_rs_tpu_torch.utils.profiling import StageTimer

log = logging.getLogger(__name__)

SLICE2 = "ROADMAP.md Queue 1 item 5"


@dataclasses.dataclass
class ArrowSpaceBuilder:
    """Fluent builder (reference defaults). ``device=None`` builds on the
    CUDA card and raises without one; pass ``device="cpu"`` for the CPU."""

    lambda_eps: float = 1e-3
    lambda_k: int = 6
    lambda_topk: int = 3
    lambda_p: float = 2.0
    lambda_sigma: Optional[float] = None
    normalise: bool = False
    sparsity_check: bool = False

    synthesis: TauMode = TAUDEFAULT
    prebuilt_spectral: bool = False

    sampling: Optional[tuple[str, float]] = ("simple", 0.6)

    cluster_max_clusters: Optional[int] = None
    cluster_radius: float = 1.0
    clustering_seed: Optional[int] = None

    persistence: Optional[tuple[str, Path]] = None

    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # -- fluent config -------------------------------------------------
    def with_lambda_graph(self, eps: float, k: int, p: float = 2.0,
                          sigma: Optional[float] = None) -> "ArrowSpaceBuilder":
        self.lambda_eps, self.lambda_k = eps, k
        self.lambda_p, self.lambda_sigma = p, sigma
        return self

    def with_synthesis(self, taumode: TauMode) -> "ArrowSpaceBuilder":
        self.synthesis = taumode
        return self

    def with_spectral(self, enabled: bool = True) -> "ArrowSpaceBuilder":
        self.prebuilt_spectral = enabled
        return self

    def with_normalisation(self, enabled: bool) -> "ArrowSpaceBuilder":
        self.normalise = enabled
        return self

    def with_sparsity_check(self, enabled: bool) -> "ArrowSpaceBuilder":
        self.sparsity_check = enabled
        return self

    def with_sampling(self, kind_rate: Optional[tuple[str, float]]) -> "ArrowSpaceBuilder":
        self.sampling = kind_rate
        return self

    def with_cluster_params(self, max_clusters: Optional[int] = None,
                            radius: Optional[float] = None) -> "ArrowSpaceBuilder":
        if max_clusters is not None:
            self.cluster_max_clusters = max_clusters
        if radius is not None:
            self.cluster_radius = radius
        return self

    def with_seed(self, seed: int) -> "ArrowSpaceBuilder":
        self.clustering_seed = seed
        return self

    def with_dims_reduction(self, enabled: bool, rp_eps: float = 0.3) -> "ArrowSpaceBuilder":
        if enabled:
            raise NotImplementedError(
                f"the JL projection draws from jax.random and is not ported yet: {SLICE2}"
            )
        return self

    def with_persistence(self, name: str, path) -> "ArrowSpaceBuilder":
        self.persistence = (name, Path(path))
        return self

    # -- helpers -------------------------------------------------------
    def graph_params(self) -> GraphParams:
        return GraphParams(
            eps=self.lambda_eps, k=self.lambda_k, topk=self.lambda_topk,
            p=self.lambda_p, sigma=self.lambda_sigma, normalise=self.normalise,
            sparsity_check=self.sparsity_check,
        )

    def define_result_k(self) -> None:
        """topk heuristic for small k."""
        if self.lambda_k <= 5:
            self.lambda_topk = 3
        elif self.lambda_k < 10:
            self.lambda_topk = 4

    def _cluster_working(self, aspace: ArrowSpace, working: np.ndarray) -> np.ndarray:
        """Sampler → incremental clustering; returns the centroids."""
        if self.cluster_max_clusters is None:
            raise NotImplementedError(
                "compute_optimal_k (k-means++ on jax.random) is not ported yet: "
                f"set with_cluster_params(max_clusters=...) ({SLICE2})"
            )
        n_items = working.shape[0]
        sampler: Optional[InlineSampler] = None
        if n_items > 1000 and self.sampling is not None:
            kind, rate = self.sampling
            sampler = make_sampler(kind, rate, seed=self.clustering_seed or 0)
        radius = self.cluster_radius
        out = clus.incremental_clustering(
            working, max_clusters=self.cluster_max_clusters, radius=radius,
            sampler=sampler,
        )
        aspace.n_clusters = len(out.centroids)
        aspace.cluster_assignments = out.assignments
        aspace.cluster_sizes = out.sizes
        aspace.cluster_radius = radius
        return out.centroids

    def start_clustering(self, rows: np.ndarray) -> tuple[ArrowSpace, np.ndarray]:
        rows = np.asarray(rows, np.float32)
        aspace = ArrowSpace.from_items(rows, self.synthesis, device=self.device)
        return aspace, self._cluster_working(aspace, rows)

    # -- build ---------------------------------------------------------
    def build(self, rows) -> tuple[ArrowSpace, GraphLaplacian]:
        """Full eigen build; stage times land in ``last_stage_timings``."""
        if self.persistence is not None:
            raise NotImplementedError(f"persistence is not ported yet: {SLICE2}")
        rows = np.asarray(rows, np.float32)
        n_items = rows.shape[0]
        t0 = time.time()
        self.define_result_k()
        timer = StageTimer(self.device)

        with timer.stage("clustering", items=n_items):
            aspace, centroids = self.start_clustering(rows)
        with timer.stage("laplacian", items=int(centroids.shape[1])):
            gl = em.eigenmaps(aspace, self, centroids, n_items)
        with timer.stage("taumode", items=n_items):
            aspace.compute_taumode(gl)
        with timer.stage("sorted-index", items=n_items):
            aspace.build_lambdas_sorted()
        self.last_stage_timings = timer.as_dict()
        log.info("ArrowSpace build complete: %d items, %d centroids, %.3fs",
                 n_items, aspace.n_clusters, time.time() - t0)
        return aspace, gl
