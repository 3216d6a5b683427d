"""Radius-gated incremental clustering (twin of the reference's
``clustering.incremental_clustering`` and its sequential fallback).

The fast path is the native C++ scan (:mod:`matternet_rs_tpu_torch.native`);
without it, the Python sequential scan gives the same centroids. The
reference's ``compute_optimal_k`` draws k-means++ seeds from
``jax.random`` and waits for a later slice (ROADMAP.md Queue 1 item 5):
the builder here needs ``with_cluster_params(max_clusters=...)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from matternet_rs_tpu_torch import native as native_mod
from matternet_rs_tpu_torch.sampling import InlineSampler, SimpleRandomSampler

RELAX_FACTOR = 1.5
CREATE_FACTOR = 0.5


@dataclasses.dataclass
class ClusteredOutput:
    centroids: np.ndarray               # [C, F]
    assignments: np.ndarray             # [N] int, -1 for dropped outliers
    sizes: np.ndarray                   # [C]
    radius: float
    n_items: int
    n_features: int


def incremental_clustering(
    X, max_clusters: int, radius: float, sampler: Optional[InlineSampler] = None,
) -> ClusteredOutput:
    """Radius-gated create/assign scan with inline sampling; assignments
    are -1 for dropped outliers. A ``SimpleRandomSampler`` draws its keep
    mask up front (as the reference does) so the native scan can take it;
    other samplers read live state and take the Python scan."""
    X = np.asarray(X, np.float32)
    n, f = X.shape

    keep_mask = None
    if sampler is not None and type(sampler) is SimpleRandomSampler:
        keep_mask = (sampler.rng.random(n) < sampler.rate).astype(np.uint8)
        sampler.stats.sampled += int(keep_mask.sum())
        sampler.stats.discarded += int(n - keep_mask.sum())
        sampler = None

    if sampler is None:
        out = native_mod.incremental_cluster(X, max_clusters, radius, keep_mask)
        if out is not None:
            cents, assignments, counts = out
            if len(cents) == 0:
                raise ValueError(
                    "No clusters created from data (sampling too aggressive?)"
                )
            return ClusteredOutput(cents, assignments, counts, radius, n, f)
    return _incremental_sequential(X, max_clusters, radius, sampler, keep_mask)


def _incremental_sequential(
    X, max_clusters, radius, sampler, keep_mask=None
) -> ClusteredOutput:
    n, f = X.shape
    cents = np.zeros((max_clusters, f), np.float64)
    counts = np.zeros(max_clusters, np.int64)
    ncent = 0
    assignments = np.full(n, -1, np.int64)

    for i in range(n):
        if keep_mask is not None and not keep_mask[i]:
            continue
        row = X[i].astype(np.float64)
        if ncent == 0:
            best_d = np.inf
        else:
            d2 = np.sum((cents[:ncent] - row) ** 2, axis=1)
            best_idx = int(np.argmin(d2))
            best_d = float(d2[best_idx])

        if sampler is not None and not sampler.should_keep(best_d, ncent, max_clusters):
            continue

        if ncent == 0:
            cents[0] = row
            counts[0] = 1
            assignments[i] = 0
            ncent = 1
        elif ncent < max_clusters and best_d > radius * CREATE_FACTOR:
            cents[ncent] = row
            counts[ncent] = 1
            assignments[i] = ncent
            ncent += 1
        elif best_d <= radius:
            counts[best_idx] += 1
            cents[best_idx] += (row - cents[best_idx]) / counts[best_idx]
            assignments[i] = best_idx
        elif best_d <= radius * RELAX_FACTOR:
            # Soft outlier: counted, centroid not moved.
            counts[best_idx] += 1
            assignments[i] = best_idx

    if ncent == 0:
        raise ValueError("No clusters created from data (sampling too aggressive?)")
    return ClusteredOutput(
        centroids=cents[:ncent].astype(np.float32),
        assignments=assignments,
        sizes=counts[:ncent].copy(),
        radius=radius,
        n_items=n,
        n_features=f,
    )
