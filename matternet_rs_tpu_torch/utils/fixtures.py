"""Deterministic synthetic datasets (own copy of the reference's
``utils/fixtures.py`` generators the port needs; numpy streams, so the same
seed gives the same arrays in both packages)."""

from __future__ import annotations

import numpy as np


def _blobs(n_points, noise, dims, centers, outlier_frac, outlier_lo, outlier_hi, seed):
    rng = np.random.default_rng(seed)
    n_outliers = int(round(n_points * outlier_frac))
    n_cluster = n_points - n_outliers
    k = len(centers)
    base, rem = divmod(n_cluster, k)
    sizes = [base + (1 if i < rem else 0) for i in range(k)]

    rows = []
    for center, size in zip(centers, sizes):
        rows.append(rng.normal(center, noise, size=(size, dims)))
    rows.append(rng.uniform(outlier_lo, outlier_hi, size=(n_outliers, dims)))
    out = np.concatenate(rows, axis=0)[:n_points]
    while len(out) < n_points:
        out = np.concatenate(
            [out, rng.uniform(outlier_lo, outlier_hi, size=(1, dims))], axis=0
        )
    rng.shuffle(out)
    return out


def make_gaussian_blob(n_points: int, noise: float) -> np.ndarray:
    """3 clusters + 15% outliers in 10-D."""
    dims = 10
    c0 = np.zeros(dims)
    c1 = np.zeros(dims); c1[0] = 10.0
    c2 = np.zeros(dims); c2[1] = 10.0
    return _blobs(n_points, noise, dims, [c0, c1, c2], 0.15, -5.0, 15.0, 789)


def make_gaussian_hd(n_points: int, noise: float) -> np.ndarray:
    """3 clusters + 15% outliers in 100-D (the staged pipeline's fixture)."""
    dims = 100
    c0 = np.zeros(dims)
    c1 = np.zeros(dims); c1[0] = 10.0
    c2 = np.zeros(dims); c2[1] = 10.0
    return _blobs(n_points, noise, dims, [c0, c1, c2], 0.15, -5.0, 15.0, 435)


def make_energy_test_dataset(n_items: int, n_features: int, seed: int) -> np.ndarray:
    """5 separated clusters, uniform ±0.8 noise."""
    rng = np.random.default_rng(seed)
    n_clusters = 5
    per = n_items // n_clusters
    rows = []
    for cid in range(n_clusters):
        center = np.zeros(n_features)
        center[0] = cid * 10.0
        center[1] = (cid % 2) * 10.0
        noise = rng.random((per, n_features)) * 2.0 - 1.0
        rows.append(center[None, :] + noise * 0.8)
    rem = n_items - per * n_clusters
    if rem:
        rows.append(rng.random((rem, n_features)) * 2.0 - 1.0)
    return np.concatenate(rows, axis=0)
