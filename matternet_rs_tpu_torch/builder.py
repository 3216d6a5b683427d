"""ArrowSpaceBuilder: the fluent eigen-build API (twin of the reference's
``builder.py``).

``build`` runs: the optimal-k heuristics unless ``max_clusters`` is set
(``clustering.compute_optimal_k``, on the builder's device) → incremental
clustering (host C++) → the centroids' JL projection with
``with_dims_reduction(True)`` → feature-space Laplacian from the
centroids (ELL-backed from 8192 features) → taumode λ (kernel A from 32768
rows; the sparse ELL route beyond 2048 features; of the projected rows
when the graph is r × r) → normalisation → sorted-λ index, all on the
builder's device. ``with_persistence`` writes the reference's Parquet
artifacts along the way (:mod:`.storage.parquet`). ``build_energy`` (or
``build_for_persistence(pipeline="energy")``) runs the energy pipeline
(:mod:`.energymaps`).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from matternet_rs_tpu_torch import clustering as clus
from matternet_rs_tpu_torch import eigenmaps as em
from matternet_rs_tpu_torch import energymaps
from matternet_rs_tpu_torch.backend import resolve_device
from matternet_rs_tpu_torch.core import TAUDEFAULT, ArrowSpace, TauMode
from matternet_rs_tpu_torch.graph import GraphLaplacian, GraphParams
from matternet_rs_tpu_torch.reduction import ImplicitProjection, compute_jl_dimension, project_matrix
from matternet_rs_tpu_torch.sampling import InlineSampler, make_sampler
from matternet_rs_tpu_torch.utils.profiling import StageTimer

log = logging.getLogger(__name__)


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
    deterministic_clustering: bool = False

    use_dims_reduction: bool = False
    rp_eps: float = 0.3

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
            # A user radius stays when the heuristics choose k.
            self._radius_user_set = True
        return self

    def with_seed(self, seed: int) -> "ArrowSpaceBuilder":
        self.clustering_seed = seed
        return self

    def with_deterministic_clustering(self, enabled: bool = True) -> "ArrowSpaceBuilder":
        self.deterministic_clustering = enabled
        return self

    def with_dims_reduction(self, enabled: bool, rp_eps: float = 0.3) -> "ArrowSpaceBuilder":
        self.use_dims_reduction = enabled
        self.rp_eps = rp_eps
        return self

    def with_persistence(self, name: str, path) -> "ArrowSpaceBuilder":
        self.persistence = (name, Path(path))
        return self

    def with_expected_items(self, n: int) -> "ArrowSpaceBuilder":
        """Dataset-size hint (the energy build's adaptive token count)."""
        self.nitems = int(n)
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

    def _cluster_working(self, aspace: ArrowSpace, working: np.ndarray,
                         resident=None) -> np.ndarray:
        """Sampler → optimal-k heuristics (unless ``max_clusters`` is set) →
        incremental clustering, in ``working``'s space (raw or JL-reduced);
        returns the centroids. ``resident`` is ``working``'s copy on the
        device, if there is one: the heuristics' neighbour search reads it."""
        n_items = working.shape[0]
        sampler: Optional[InlineSampler] = None
        if n_items > 1000 and self.sampling is not None:
            kind, rate = self.sampling
            sampler = make_sampler(kind, rate, seed=self.clustering_seed or 0)

        if self.cluster_max_clusters is not None:
            k_opt, radius = self.cluster_max_clusters, self.cluster_radius
        else:
            if self.clustering_seed is None:
                raise ValueError("clustering_seed must be set for full heuristics")
            k_opt, radius, _ = clus.compute_optimal_k(
                working if resident is None else resident, self.clustering_seed, self.device)
            if getattr(self, "_radius_user_set", False):
                radius = self.cluster_radius
            self.cluster_max_clusters, self.cluster_radius = k_opt, radius

        out = clus.incremental_clustering(
            working, max_clusters=k_opt, radius=radius, sampler=sampler,
            deterministic=self.deterministic_clustering or n_items <= 4096,
            device=self.device,
        )
        aspace.n_clusters = len(out.centroids)
        aspace.cluster_assignments = out.assignments
        aspace.cluster_sizes = out.sizes
        aspace.cluster_radius = radius
        return out.centroids

    def _projection(self, n_features: int, target: int) -> ImplicitProjection:
        # Seed 0 is a user seed: only None means unset.
        return ImplicitProjection(
            n_features, target, 42 if self.clustering_seed is None else self.clustering_seed
        )

    def start_clustering(self, rows: np.ndarray, device_rows=None) -> tuple[ArrowSpace, np.ndarray]:
        """Clustering in the raw space; with ``use_dims_reduction`` and
        F > 64 the centroids are then JL-projected when the target width
        ``min(jl_dim(C, F, ε), F // 2)`` exceeds the centroid count.
        ``device_rows``: a float32 tensor holding the same corpus, taken as
        the space's data instead of a new upload (``ValueError`` on another
        shape or dtype; equal content is the caller's contract)."""
        rows = np.asarray(rows, np.float32)
        n_items, n_features = rows.shape
        if device_rows is not None:
            if tuple(device_rows.shape) != (n_items, n_features):
                raise ValueError(
                    f"device_rows shape {tuple(device_rows.shape)} != "
                    f"rows shape {(n_items, n_features)}"
                )
            if device_rows.dtype != torch.float32:
                raise ValueError(
                    f"device_rows dtype {device_rows.dtype} != float32: "
                    "device_rows must be the float32 device copy of rows "
                    "(a reduced-precision copy no longer equals rows)"
                )
        aspace = ArrowSpace.from_items(rows if device_rows is None else device_rows,
                                       self.synthesis, device=self.device)
        centroids = self._cluster_working(aspace, rows, resident=aspace.data)
        if self.use_dims_reduction and n_features > 64:
            jl_dim = compute_jl_dimension(aspace.n_clusters, n_features, self.rp_eps)
            target = min(jl_dim, n_features // 2)
            if target < n_features and target > centroids.shape[0]:
                proj = self._projection(n_features, target)
                centroids = project_matrix(centroids, proj, self.device).cpu().numpy()
                aspace.projection = proj
                aspace.reduced_dim = target
        return aspace, centroids

    def start_clustering_dim_reduce(self, rows: np.ndarray) -> tuple[ArrowSpace, np.ndarray]:
        """Early JL: with ``use_dims_reduction`` and F > 1000, every row is
        projected to ``max(min(jl_dim(N, F, ε), F // 2), 64)`` columns first
        (in row blocks of ≈ 64 MB), and the heuristics and the clustering
        run in the reduced space. The space keeps the original rows and the
        projection; the centroids come back reduced."""
        rows = np.asarray(rows, np.float32)
        n_items, n_features = rows.shape
        aspace = ArrowSpace.from_items(rows, self.synthesis, device=self.device)
        working, resident = rows, aspace.data
        if self.use_dims_reduction and n_features > 1000:
            jl_dim = compute_jl_dimension(n_items, n_features, self.rp_eps)
            target = max(min(jl_dim, n_features // 2), 64)
            proj = self._projection(n_features, target)
            blk = max(1, (16 << 20) // max(n_features, 1))
            working = np.concatenate([
                project_matrix(aspace.data[i:i + blk], proj).cpu().numpy()
                for i in range(0, n_items, blk)
            ], axis=0)
            resident = None
            aspace.projection = proj
            aspace.reduced_dim = target
            log.info("early JL projection: %d → %d dims (ε=%.2f, %.1fx compression)",
                     n_features, target, self.rp_eps, n_features / target)
        return aspace, self._cluster_working(aspace, working, resident)

    # -- build ---------------------------------------------------------
    def build(self, rows, device_rows=None) -> tuple[ArrowSpace, GraphLaplacian]:
        """Full eigen build; stage times land in ``last_stage_timings``.
        With persistence: the raw rows, the centroids (twice, as the
        reference names them), the Laplacian, the signals, the λ and the
        metadata. ``device_rows``: the same corpus already on the device
        (for instance a previous build's ``data``, to rebuild with other
        graph or λ settings), reused instead of uploaded again; the host
        ``rows`` still drive the clustering scan."""
        rows = np.asarray(rows, np.float32)
        n_items = rows.shape[0]
        t0 = time.time()
        self.define_result_k()
        self._persist_dense("raw_input", rows)
        timer = StageTimer(self.device)

        with timer.stage("clustering", items=n_items):
            aspace, centroids = self.start_clustering(rows, device_rows)
        self._persist_dense("clustered-dm", centroids)
        self._persist_dense("laplacian-input", centroids)
        with timer.stage("laplacian", items=int(centroids.shape[1])):
            gl = em.eigenmaps(aspace, self, centroids, n_items)
        if self.persistence is not None:
            self._persist_sparse("gl-matrix", gl.dense().cpu().numpy())
            if self.prebuilt_spectral and aspace.signals is not None:
                self._persist_sparse("aspace-signals", aspace.signals.cpu().numpy())
        with timer.stage("taumode", items=n_items):
            aspace.compute_taumode(gl)
        with timer.stage("sorted-index", items=n_items):
            aspace.build_lambdas_sorted()
        self._persist_lambdas(aspace)
        self.last_stage_timings = timer.as_dict()
        log.info("ArrowSpace build complete: %d items, %d centroids, %.3fs",
                 n_items, aspace.n_clusters, time.time() - t0)
        return aspace, gl

    def build_for_persistence(self, rows, pipeline: str = "eigen",
                              energy_params=None) -> tuple[ArrowSpace, GraphLaplacian]:
        """The build of ``pipeline``: ``"eigen"`` (or ``"default"``) or
        ``"energy"``."""
        if pipeline in ("eigen", "default"):
            return self.build(rows)
        if pipeline == "energy":
            return self.build_energy(rows, energy_params)
        raise ValueError(f"unknown pipeline {pipeline!r} (eigen|energy|default)")

    def build_energy(self, rows, energy_params=None) -> tuple[ArrowSpace, GraphLaplacian]:
        """The energy build (:func:`..energymaps.build_energy`); with
        persistence it writes the raw rows, the energy graph and the λ with
        the metadata."""
        aspace, gl = energymaps.build_energy(self, rows, energy_params)
        if self.persistence is not None:
            self._persist_dense("raw_input", aspace.data.cpu().numpy())
            self._persist_sparse("gl-matrix", gl.dense().cpu().numpy())
            self._persist_lambdas(aspace)
        return aspace, gl

    # -- persistence hooks ---------------------------------------------
    def _persist_dense(self, tag: str, arr: np.ndarray) -> None:
        if self.persistence is None:
            return
        from matternet_rs_tpu_torch.storage import parquet as pq

        name, path = self.persistence
        pq.save_dense_matrix(arr, path, f"{name}-{tag}", builder=self)

    def _persist_sparse(self, tag: str, arr: np.ndarray) -> None:
        if self.persistence is None:
            return
        from matternet_rs_tpu_torch.storage import parquet as pq

        name, path = self.persistence
        pq.save_sparse_matrix(arr, path, f"{name}-{tag}", builder=self)

    def _persist_lambdas(self, aspace: ArrowSpace) -> None:
        if self.persistence is None:
            return
        from matternet_rs_tpu_torch.storage import parquet as pq

        name, path = self.persistence
        pq.save_lambdas(aspace.lambdas.cpu().numpy(), path, f"{name}-lambdas", builder=self)
        pq.save_arrowspace_metadata(aspace, self, path, name)
