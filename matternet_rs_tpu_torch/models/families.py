"""fit/query façades for the three index families. Each takes the
reference's fields and defaults plus a trailing ``device`` (None: the CUDA
card, raising without one); what they return to the host (``lambdas``,
``centroids``) is a numpy array."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder
from matternet_rs_tpu_torch.core import TAUDEFAULT, ArrowSpace, TauMode
from matternet_rs_tpu_torch.graph import GraphLaplacian


class _FittedMixin:
    aspace: Optional[ArrowSpace]
    gl: Optional[GraphLaplacian]

    def _check_fitted(self):
        if self.aspace is None:
            raise ValueError("call fit(X) first")

    def save(self, path, name: str = "index") -> None:
        self._check_fitted()
        from matternet_rs_tpu_torch.storage import parquet as pq

        pq.save_checkpoint(self.aspace, self.gl, self.builder, path, name)

    @property
    def lambdas(self) -> np.ndarray:
        self._check_fitted()
        return self.aspace.lambdas.cpu().numpy()


@dataclasses.dataclass
class EigenIndex(_FittedMixin):
    """λτ-graph index (the canonical eigen build)."""

    eps: float = 1e-3
    k: int = 6
    p: float = 2.0
    sigma: Optional[float] = None
    taumode: TauMode = TAUDEFAULT
    max_clusters: Optional[int] = None
    radius: Optional[float] = None
    seed: Optional[int] = 42
    dims_reduction: bool = False
    spectral: bool = False
    alpha: float = 0.7

    aspace: Optional[ArrowSpace] = None
    gl: Optional[GraphLaplacian] = None
    builder: Optional[ArrowSpaceBuilder] = None
    device: Optional[str] = None

    def fit(self, X) -> "EigenIndex":
        b = (
            ArrowSpaceBuilder(device=self.device)
            .with_lambda_graph(self.eps, self.k, self.p, self.sigma)
            .with_synthesis(self.taumode)
            .with_sparsity_check(False)
            .with_spectral(self.spectral)
            .with_dims_reduction(self.dims_reduction)
        )
        if self.seed is not None:
            b.with_seed(self.seed)
        if self.max_clusters is not None or self.radius is not None:
            b.with_cluster_params(self.max_clusters, self.radius)
        self.builder = b
        self.aspace, self.gl = b.build(np.asarray(X, np.float32))
        return self

    def query(self, q, k: int = 10, alpha: Optional[float] = None):
        self._check_fitted()
        from matternet_rs_tpu_torch import eigenmaps

        return eigenmaps.search(
            self.aspace, q, self.gl, k, alpha if alpha is not None else self.alpha
        )

    def query_batch(
        self, Q, k: int = 10, alpha: Optional[float] = None,
        approx: bool = False, quantized: bool | str = False,
        candidates: Optional[int] = None, recall_target: float = 0.95,
        allow_low_recall: bool = False,
    ):
        """Batched search with the full tier ladder (``quantized``: False /
        True / "auto" / "int8" / "int8_rescored" / "int8_auto" /
        "bf16x3_rescored"; ``"bf16_rescored"`` needs
        ``allow_low_recall=True`` — ``ArrowSpace.search_batch``). Returns
        ``(indices [B, k], scores [B, k])``."""
        self._check_fitted()
        return self.aspace.search_batch(
            Q, self.gl, k, alpha if alpha is not None else self.alpha,
            approx=approx, quantized=quantized, candidates=candidates,
            recall_target=recall_target, allow_low_recall=allow_low_recall,
        )


@dataclasses.dataclass
class EnergyIndex(_FittedMixin):
    """Cosine-free energy index (the energy build)."""

    eps: float = 1.0
    k: int = 5
    taumode: TauMode = TAUDEFAULT
    max_clusters: Optional[int] = None
    radius: Optional[float] = None
    seed: Optional[int] = 42
    energy_params: object = None

    aspace: Optional[ArrowSpace] = None
    gl: Optional[GraphLaplacian] = None
    builder: Optional[ArrowSpaceBuilder] = None
    device: Optional[str] = None

    def fit(self, X) -> "EnergyIndex":
        b = (
            ArrowSpaceBuilder(device=self.device)
            .with_lambda_graph(self.eps, self.k)
            .with_synthesis(self.taumode)
            .with_sparsity_check(False)
            .with_dims_reduction(True)
        )
        if self.seed is not None:
            b.with_seed(self.seed)
        if self.max_clusters is not None or self.radius is not None:
            b.with_cluster_params(self.max_clusters, self.radius)
        self.builder = b
        self.aspace, self.gl = b.build_energy(
            np.asarray(X, np.float32), self.energy_params
        )
        return self

    def query(self, q, k: int = 10):
        self._check_fitted()
        from matternet_rs_tpu_torch import energymaps

        return energymaps.search_energy(self.aspace, q, self.gl, k)


@dataclasses.dataclass
class SurffaceModel:
    """Staged A→D pipeline."""

    config: object = None
    result: object = None
    device: Optional[str] = None

    def fit(self, X) -> "SurffaceModel":
        from matternet_rs_tpu_torch import pipeline

        self.result = pipeline.build(
            np.asarray(X, np.float32), self.config, device=self.device
        )
        return self

    @property
    def lambdas(self) -> np.ndarray:
        if self.result is None:
            raise ValueError("call fit(X) first")
        return self.result.lambdas

    @property
    def centroids(self) -> np.ndarray:
        if self.result is None:
            raise ValueError("call fit(X) first")
        return self.result.state.means.cpu().numpy()
