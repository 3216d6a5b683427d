"""EigenMaps staged API: centroids → Laplacian → taumode λ → search (twin
of the reference's ``eigenmaps.py``)."""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from matternet_rs_tpu_torch.core import ArrowSpace
from matternet_rs_tpu_torch.graph import GraphLaplacian
from matternet_rs_tpu_torch.ops import laplacian as lap_ops

if TYPE_CHECKING:
    from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder


def eigenmaps(aspace: ArrowSpace, builder: "ArrowSpaceBuilder", centroids,
              n_items: int) -> GraphLaplacian:
    """Feature-space Laplacian from ``[C, F]`` centroids, on the space's
    device; with ``builder.prebuilt_spectral`` also the F×F signals."""
    centroids = torch.as_tensor(centroids, dtype=torch.float32, device=aspace.device)
    gl = lap_ops.build_laplacian_from_k_cluster(
        centroids, builder.graph_params(), n_items=n_items
    )
    if builder.prebuilt_spectral:
        aspace.signals = lap_ops.build_spectral_laplacian(gl, n_items)
    return gl


def compute_taumode(aspace: ArrowSpace, gl: GraphLaplacian) -> None:
    aspace.compute_taumode(gl)


def search(aspace: ArrowSpace, item, gl: GraphLaplacian, k: int,
           alpha: float = 0.7) -> list[tuple[int, float]]:
    """Prepare the query's λ, then the λ-aware ranking."""
    q_lambda = aspace.prepare_query_item(item, gl)
    return aspace.search_lambda_aware(item, q_lambda, k, alpha)
