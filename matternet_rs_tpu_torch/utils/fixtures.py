"""Deterministic synthetic datasets (own copy of the reference's
``utils/fixtures.py``; numpy streams, so the same arguments give the same
arrays, bit for bit, in both packages)."""

from __future__ import annotations

import numpy as np


def make_moons_hd(
    n: int, noise_xy: float, noise_hd: float, dims: int, seed: int
) -> np.ndarray:
    """Two-moons embedded in ``dims`` dimensions."""
    rng = np.random.default_rng(seed)
    n0 = n // 2
    n1 = n - n0
    out = np.zeros((n, dims), np.float64)

    t = rng.random(n0) * np.pi
    out[:n0, 0] = np.cos(t) + noise_xy * rng.random(n0)
    out[:n0, 1] = np.sin(t) + noise_xy * rng.random(n0)
    out[:n0, 2:] = noise_hd * rng.random((n0, dims - 2))

    t = rng.random(n1) * np.pi
    out[n0:, 0] = 1.0 - np.cos(t) + noise_xy * rng.random(n1)
    out[n0:, 1] = -np.sin(t) - 0.5 + noise_xy * rng.random(n1)
    out[n0:, 2:] = noise_hd * rng.random((n1, dims - 2))
    return out


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


def make_gaussian_cliques(
    n_per: int, noise: float, n_out: int, dims: int, seed: int
) -> np.ndarray:
    """3 tight blobs + 3 bridge points + outliers."""
    rng = np.random.default_rng(seed)
    centers = []
    c = np.zeros(dims); c[0] = 10.0; centers.append(c)
    c = np.zeros(dims); c[1] = 10.0; centers.append(c)
    c = np.zeros(dims); c[0] = -10.0; c[1] = -10.0; centers.append(c)

    rows = [rng.normal(ctr, noise, size=(n_per, dims)) for ctr in centers]
    bridges = []
    for b0, b1 in [(0.5, 0.5), (0.7, 0.3), (0.3, 0.7)]:
        v = np.zeros(dims)
        v[0] = 10.0 * b0 - 10.0 * (1.0 - b0)
        v[1] = 10.0 * b1 - 10.0 * (1.0 - b1)
        v[2:] = rng.normal(0.0, noise, size=dims - 2)
        bridges.append(v)
    rows.append(np.stack(bridges))
    rows.append(rng.uniform(-5.0, 15.0, size=(n_out, dims)))
    return np.concatenate(rows, axis=0)


def make_gaussian_cliques_multi(
    n_points: int, noise: float, n_cliques: int, dims: int, seed: int
) -> np.ndarray:
    """Grid of separated cliques + 5% outliers."""
    rng = np.random.default_rng(seed)
    n_outliers = int(round(n_points * 0.05))
    n_cluster = n_points - n_outliers
    base, rem = divmod(n_cluster, n_cliques)
    grid = int(np.ceil(np.sqrt(n_cliques)))
    spacing = 20.0

    rows = []
    for i in range(n_cliques):
        center = np.zeros(dims)
        center[0] = (i % grid) * spacing
        if dims > 1:
            center[1] = (i // grid) * spacing
        size = base + (1 if i < rem else 0)
        rows.append(rng.normal(center, noise, size=(size, dims)))
    hi = grid * spacing + 10.0
    rows.append(rng.uniform(-10.0, hi, size=(n_outliers, dims)))
    out = np.concatenate(rows, axis=0)[:n_points]
    while len(out) < n_points:
        out = np.concatenate([out, rng.uniform(-10.0, hi, size=(1, dims))], axis=0)
    rng.shuffle(out)
    return out


def make_cosine_tied_smoothness_dataset(
    n_directions: int = 40,
    per_style: int = 10,
    n_groups: int = 8,
    group_size: int = 8,
    noise: float = 0.45,
    seed: int = 0,
):
    """Dataset where cosine is deliberately ambiguous and only spectral
    smoothness separates relevant items from distractors.

    Features come in ``n_groups`` correlated groups. Every item of a
    direction ``m`` shares the same per-group means ``g`` (so all of them
    are cosine-close to a query from that direction), but comes in two
    styles with equal-magnitude noise: *smooth* (group-constant noise —
    low Dirichlet energy against the feature graph) and *rough*
    (sign-alternating noise within each group — high energy). A pure
    cosine ranker cannot tell the styles apart; the λ term can. This is
    the product claim of the reference's λ-aware search
    reduced to a measurable fixture.

    Returns ``(X [n_directions·2·per_style, n_groups·group_size] f32,
    direction_labels, style_labels)`` with style 0 = smooth, 1 = rough.
    """
    if group_size % 2:
        raise ValueError("group_size must be even (alternating-sign pattern)")
    rng = np.random.default_rng(seed)
    ones = np.ones(group_size)
    alt = np.tile([1.0, -1.0], group_size // 2)

    def expand(g, pat):
        return np.repeat(g, group_size) * np.tile(pat, n_groups)

    items, labels, styles = [], [], []
    for m in range(n_directions):
        # |g| bounded away from 0: tiny group means make the item's λ
        # noise-dominated, which blurs the style separation.
        g = rng.choice([-1.0, 1.0], n_groups) * rng.uniform(0.7, 1.5, n_groups)
        for s, pat in ((0, ones), (1, alt)):
            for _ in range(per_style):
                h = rng.normal(size=n_groups) * noise
                items.append(expand(g, ones) + expand(h, pat))
                labels.append(m)
                styles.append(s)
    return (
        np.asarray(items, np.float32),
        np.asarray(labels),
        np.asarray(styles),
    )
