"""Clustering (twin of the reference's ``clustering.py``): k-means with
k-means++ seeds, the optimal-k heuristics and the radius-gated incremental
clustering.

* :func:`kmeans_lloyd` — :func:`kmeanspp_init`, then Lloyd's iterations,
  on the caller's device. The seeds follow the reference's ``jax.random``
  stream (:mod:`..prng`): the first row from ``randint``, each next one by
  ``choice(p ∝ d²)``, whose uniforms are all drawn on the host before the
  loop, so the loop reads nothing back from the device. The cumulative
  sums are the device's, so a draw that lands within their rounding of a
  boundary can pick the neighbouring row.
* :func:`compute_optimal_k` — intrinsic dimension (two-NN, :mod:`..ops.knn`),
  k bounds, the penalised Calinski–Harabasz sweep, the pilot radius.
* :func:`incremental_clustering` — the native C++ scan
  (:mod:`..native`), else the Python sequential scan, or with
  ``deterministic=False`` beyond one batch the batched path, whose
  ``[batch, cap]`` distance product runs on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from matternet_rs_tpu_torch import native as native_mod
from matternet_rs_tpu_torch import prng
from matternet_rs_tpu_torch.backend import resolve_device
from matternet_rs_tpu_torch.ops._mm import mm
from matternet_rs_tpu_torch.sampling import InlineSampler, SimpleRandomSampler

RELAX_FACTOR = 1.5
CREATE_FACTOR = 0.5


def _device_rows(X, device=None) -> torch.Tensor:
    """``X`` as a float32 tensor: a tensor stays where it is, an array goes
    to ``device`` (``None`` is the CUDA card)."""
    if isinstance(X, torch.Tensor):
        return X.to(torch.float32)
    return torch.from_numpy(np.array(X, np.float32)).to(resolve_device(device))


# ---------------------------------------------------------------------------
# K-means
# ---------------------------------------------------------------------------


def kmeanspp_uniforms(seed: int, k: int) -> tuple[int, np.ndarray]:
    """The host draws of k-means++ for ``k`` seeds, as the reference's
    stream makes them: the key of ``seed`` splits into the first row's key
    and a chain whose every split gives one step's key. Returns the first
    row's ``randint`` key and ``1 − u`` of each step (float32 ``[k − 1]``)."""
    key = prng.PRNGKey(seed & 0xFFFFFFFF)
    k0, chain = prng.split(key)
    omu = np.empty(max(k - 1, 0), np.float32)
    for i in range(k - 1):
        chain, sub = prng.split(chain)
        omu[i] = np.float32(1.0) - prng.uniform(sub, ())
    return k0, omu


def kmeanspp_init(X: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """k-means++ seeds ``[k, F]`` on ``X``'s device: row
    ``randint(0, n)`` first, then each next row drawn with probability
    ∝ its squared distance to the nearest seed so far (cumulative sum,
    ``cumsum[-1]·(1 − u)``, left ``searchsorted``)."""
    k0, omu = kmeanspp_uniforms(seed, k)
    first = int(prng.randint(k0, (), 0, X.shape[0]))
    return kmeanspp_steps(X, first, torch.from_numpy(omu).to(X.device))


def kmeanspp_steps(X: torch.Tensor, first: int, omu: torch.Tensor) -> torch.Tensor:
    """The device loop of :func:`kmeanspp_init` from its host draws (the
    first row, ``1 − u`` of each step on ``X``'s device): it reads nothing
    back from the device."""
    n, k = X.shape[0], omu.shape[0] + 1
    cents = torch.empty((k, X.shape[1]), dtype=X.dtype, device=X.device)
    cents[0] = X[first]
    d_min = torch.sum((X - X[first]) ** 2, dim=-1)
    for i in range(1, k):
        probs = d_min / torch.clamp(torch.sum(d_min), min=1e-30)
        cum = torch.cumsum(probs, dim=0)
        r = cum[-1:] * omu[i - 1:i]
        # r ≤ cum[-1], so the index is < n; the clamp is the reference's
        # clamped gather, for a NaN sum.
        idx = torch.clamp(torch.searchsorted(cum, r), max=n - 1)
        c = X.index_select(0, idx)
        cents[i:i + 1] = c
        d_min = torch.minimum(d_min, torch.sum((X - c) ** 2, dim=-1))
    return cents


def _assign(X: torch.Tensor, x_sq: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    c_sq = torch.sum(cents * cents, dim=-1)[None, :]
    return torch.argmin(x_sq + c_sq - 2.0 * mm(X, cents.T), dim=1)


def lloyd(X: torch.Tensor, cents: torch.Tensor, max_iter: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``max_iter`` Lloyd steps from ``cents`` (an empty cluster keeps its
    centroid), then the final assignment. The cluster sums are a full-f32
    one-hot product, as the reference forms them."""
    k = cents.shape[0]
    x_sq = torch.sum(X * X, dim=-1, keepdim=True)
    for _ in range(max_iter):
        one_hot = torch.nn.functional.one_hot(_assign(X, x_sq, cents), k).to(X.dtype)
        counts = torch.sum(one_hot, dim=0)
        new = mm(one_hot.T, X) / torch.clamp(counts, min=1.0)[:, None]
        cents = torch.where(counts[:, None] > 0, new, cents)
    return _assign(X, x_sq, cents), cents


def kmeans_lloyd(X, k: int, max_iter: int = 20, seed: int = 0,
                 device=None) -> tuple[np.ndarray, np.ndarray]:
    """Returns ``(assignments [N], centroids [k, F])`` as numpy. ``X`` is a
    tensor (its device) or an array (``device``; ``None`` is the card)."""
    Xd = _device_rows(X, device)
    k = min(k, Xd.shape[0])
    a, c = lloyd(Xd, kmeanspp_init(Xd, k, seed), max_iter)
    return a.cpu().numpy(), c.cpu().numpy()


def _ch_score(X: torch.Tensor, a: torch.Tensor, k: int) -> torch.Tensor:
    n = X.shape[0]
    global_c = torch.mean(X, dim=0)
    one_hot = torch.nn.functional.one_hot(a, k).to(X.dtype)
    counts = torch.sum(one_hot, dim=0)
    cents = mm(one_hot.T, X) / torch.clamp(counts, min=1.0)[:, None]
    bgss = torch.sum(counts * torch.sum((cents - global_c) ** 2, dim=-1))
    diff = X - cents[a]
    wgss = torch.sum(diff * diff)
    score = (bgss / (k - 1)) / (wgss / (n - k))
    return torch.where(wgss < 1e-10, torch.zeros_like(score), score)


def calinski_harabasz_score(X, assignments, k: int, device=None) -> float:
    """Calinski–Harabasz index of ``assignments`` (0 for k ≤ 1 or k ≥ n)."""
    if k <= 1 or k >= X.shape[0]:
        return 0.0
    Xd = _device_rows(X, device)
    a = torch.from_numpy(np.array(assignments, np.int64)).to(Xd.device)
    return float(_ch_score(Xd, a, k))


# ---------------------------------------------------------------------------
# Heuristics
# ---------------------------------------------------------------------------


def estimate_intrinsic_dimension(X, seed: int = 0, device=None) -> int:
    """Two-NN estimate: mean ratio d2/d1 of the two nearest neighbours of
    ≤ 500 sampled rows; ID = 1/ln(mean ratio), clamped to [1, F]."""
    n, f = X.shape
    if n < 10:
        return min(f, 2)
    from matternet_rs_tpu_torch.ops.knn import knn

    rng = np.random.default_rng(seed + 1)
    sample = rng.permutation(n)[: min(n, 500)]
    Xd = _device_rows(X, device)
    d, _ = knn(Xd[torch.from_numpy(sample).to(Xd.device)], Xd, k=3, metric="euclidean")
    d = d.cpu().numpy()
    d1, d2 = d[:, 1], d[:, 2]          # column 0 is the row itself
    valid = d1 > 1e-12
    if not valid.any():
        return min(f, 3)
    mean_ratio = float(np.mean(d2[valid] / d1[valid]))
    ident = 1.0 / math.log(mean_ratio) if mean_ratio > 1.001 else float(f)
    return int(np.clip(round(ident), 1, f))


def step1_bounds(X, seed: int = 0, device=None) -> tuple[int, int, int]:
    """``(k_min, k_max, intrinsic dim)`` from N, F and the intrinsic
    dimension."""
    n, f = X.shape
    id_est = estimate_intrinsic_dimension(X, seed, device)
    k_min = max(math.ceil(math.sqrt(n / 10.0)), 2)
    k_max = min(f, n // 10, 5 * id_est, int(n ** 0.5))
    k_max = min(max(k_max, k_min + 1), n // 2)
    return k_min, k_max, id_est


def _best_ch(X: torch.Tensor, k: int, seeds: list[int]) -> float:
    best = 0.0
    for s in seeds:
        a, _ = kmeans_lloyd(X, k, 20, s)
        best = max(best, calinski_harabasz_score(X, a, k))
    return best


def step2_calinski_harabasz(X, k_min: int, k_max: int, seed: int = 0, device=None) -> int:
    """Penalised CH sweep (``CH − 0.8·k·ln N``, best of 3 seeded runs), a
    coarse step then a fine pass around the best; ties prefer larger k."""
    n = X.shape[0]
    if n < 10:
        return k_min
    Xd = _device_rows(X, device)
    k_range = k_max - k_min
    k_step = 1 if k_range <= 5 else (2 if k_range <= 15 else 3)
    candidates = list(range(k_min, k_max + 1, k_step))

    def penalized(k: int, mult: int) -> float:
        seeds = [seed + k * mult + t for t in range(3)]
        return _best_ch(Xd, k, seeds) - 0.8 * k * math.log(n)

    scores = [(k, penalized(k, 1000)) for k in candidates if 2 <= k < n]
    if not scores:
        return k_min
    best_k, best_score = max(scores, key=lambda t: (t[1], t[0]))

    if k_step > 1:
        fine = {
            max(best_k - (k_step - 1), 0),
            max(best_k - 1, 0),
            best_k,
            min(best_k + 1, k_max),
            min(best_k + k_step - 1, k_max),
        }
        fine = [k for k in sorted(fine) if k_min <= k <= k_max and k < n and k not in candidates]
        fine_scores = [(k, penalized(k, 10000)) for k in fine]
        if fine_scores:
            fk, fs = max(fine_scores, key=lambda t: (t[1], t[0]))
            if fs > best_score:
                best_k = fk
    return min(best_k, k_max)


def compute_threshold_from_pilot(X, k: int, seed: int = 0, device=None) -> float:
    """Radius: the 90th-percentile within-cluster squared distance × 1.5
    of a pilot k-means, with the inter-centroid fallback."""
    X = np.asarray(X, np.float32)
    a, cents = kmeans_lloyd(X, k, 20, seed + 100000, device)
    counts = np.bincount(a, minlength=len(cents))
    d2 = np.sum((X - cents[a]) ** 2, axis=-1).astype(np.float64)
    if d2.size == 0:
        return 1.0
    d2s = np.sort(d2)
    idx = min(math.ceil(len(d2s) * 0.9), len(d2s) - 1)
    p90 = float(d2s[idx])

    nonempty = cents[counts > 0]
    if len(nonempty) > 1:
        pd = np.sum(
            (nonempty[:, None, :] - nonempty[None, :, :]) ** 2, axis=-1
        ).astype(np.float64)
        iu = np.triu_indices(len(nonempty), 1)
        min_inter = float(pd[iu].min()) if iu[0].size else float("inf")
    else:
        min_inter = float("inf")

    ratio = p90 / min_inter if np.isfinite(min_inter) and min_inter > 0 else 1.0
    if p90 < 1e-8 or ratio < 0.01:
        if np.isfinite(min_inter):
            return max(min_inter * 0.15, 1e-6)
        return 1e-6
    return max(p90 * 1.5, 1e-6)


def compute_optimal_k(X, seed: int = 0, device=None) -> tuple[int, float, int]:
    """``(k_optimal, radius, intrinsic_dim)``. ``X`` is an array or a tensor
    (the bounds' neighbour search runs on its device); the sweep and the
    pilot take ≤ 1000 sampled rows."""
    n = X.shape[0]
    k_min, k_max, id_est = step1_bounds(X, seed, device)
    rng = np.random.default_rng(seed)
    sample = rng.permutation(n)[: min(n, 1000)] if n > 1000 else np.arange(n)
    if isinstance(X, torch.Tensor):
        device = X.device
        Xs = X[torch.from_numpy(sample).to(X.device)].to(torch.float32).cpu().numpy()
    else:
        Xs = np.asarray(X, np.float32)[sample]
    k_opt = step2_calinski_harabasz(Xs, k_min, k_max, seed, device)
    radius = compute_threshold_from_pilot(Xs, k_opt, seed, device)
    return k_opt, radius, id_est


# ---------------------------------------------------------------------------
# Incremental clustering (radius-gated create/assign)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ClusteredOutput:
    centroids: np.ndarray               # [C, F] (or [C, r] if projected)
    assignments: np.ndarray             # [N] int, -1 for dropped outliers
    sizes: np.ndarray                   # [C]
    radius: float
    n_items: int
    n_features: int
    reduced_dim: Optional[int] = None


def incremental_clustering(
    X, max_clusters: int, radius: float, sampler: Optional[InlineSampler] = None,
    deterministic: bool = True, batch_size: int = 2048, device=None,
) -> ClusteredOutput:
    """Radius-gated create/assign scan with inline sampling; assignments
    are -1 for dropped outliers. A ``SimpleRandomSampler`` draws its keep
    mask up front (as the reference does) so the native scan can take it;
    other samplers read live state and take a Python scan. Without the
    native library: the sequential scan, or with ``deterministic=False``
    beyond ``batch_size`` rows the batched path on ``device``."""
    X = np.asarray(X, np.float32)
    n, f = X.shape

    keep_mask = None
    native_ok = True
    if sampler is not None:
        if type(sampler) is SimpleRandomSampler:
            keep_mask = (sampler.rng.random(n) < sampler.rate).astype(np.uint8)
            sampler.stats.sampled += int(keep_mask.sum())
            sampler.stats.discarded += int(n - keep_mask.sum())
        else:
            native_ok = False

    if native_ok:
        out = native_mod.incremental_cluster(X, max_clusters, radius, keep_mask=keep_mask)
        if out is not None:
            cents, assignments, counts, _ = out
            if len(cents) == 0:
                raise ValueError(
                    "No clusters created from data (sampling too aggressive?)"
                )
            return ClusteredOutput(cents, assignments, counts, radius, n, f)

    if deterministic or n <= batch_size:
        # The keep mask is drawn and counted once: the scan takes it in
        # place of the sampler.
        return _incremental_sequential(
            X, max_clusters, radius, sampler if keep_mask is None else None, keep_mask
        )
    return _incremental_batched(X, max_clusters, radius, sampler, batch_size, device)


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


def _batch_dists(Xb: torch.Tensor, cents: torch.Tensor, ncent: int):
    """Min d² and its argmin of the batch rows against the first ``ncent``
    rows of ``cents [cap, F]``."""
    d = (
        torch.sum(Xb * Xb, dim=-1, keepdim=True)
        + torch.sum(cents * cents, dim=-1)[None, :]
        - 2.0 * mm(Xb, cents.T)
    )
    mask = torch.arange(cents.shape[0], device=Xb.device)[None, :] < ncent
    d = torch.where(mask, torch.clamp(d, min=0.0), torch.full_like(d, float("inf")))
    return torch.min(d, dim=1)


def _incremental_batched(X, max_clusters, radius, sampler, batch_size,
                         device=None) -> ClusteredOutput:
    """Batched path: each batch's ``[batch, cap]`` distance product on the
    device, its creations and mean updates on the host (mini-batch
    snapshot semantics, as the reference's)."""
    dev = resolve_device(device)
    n, f = X.shape
    cap = max_clusters
    cents = np.zeros((cap, f), np.float64)
    counts = np.zeros(cap, np.int64)
    ncent = 0
    assignments = np.full(n, -1, np.int64)

    for start in range(0, n, batch_size):
        Xb = X[start : start + batch_size]
        if ncent == 0:
            # Bootstrap with the sequential path on the first batch.
            out = _incremental_sequential(Xb, max_clusters, radius, sampler)
            c0 = out.centroids.shape[0]
            cents[:c0] = out.centroids
            counts[:c0] = out.sizes
            ncent = c0
            assignments[start : start + len(Xb)] = out.assignments
            continue

        dmin_t, didx_t = _batch_dists(
            torch.from_numpy(np.ascontiguousarray(Xb)).to(dev),
            torch.from_numpy(cents.astype(np.float32)).to(dev), ncent,
        )
        dmin = dmin_t.cpu().numpy().astype(np.float64)
        didx = didx_t.cpu().numpy()

        keep = (
            sampler.decide_batch(dmin, ncent, max_clusters)
            if sampler is not None
            else np.ones(len(Xb), bool)
        )

        # Kept rows beyond 0.5·radius go to the sequential create loop
        # below, which checks them against live state; the rest are plain
        # assignments.
        create_mask = keep & (dmin > radius * CREATE_FACTOR)
        assign_mask = keep & ~create_mask & (dmin <= radius)

        aidx = didx[assign_mask]
        if aidx.size:
            rows = Xb[assign_mask].astype(np.float64)
            add = np.bincount(aidx, minlength=cap)
            sums = np.zeros((cap, f), np.float64)
            np.add.at(sums, aidx, rows)
            new_counts = counts + add
            upd = add > 0
            cents[upd] = (
                cents[upd] * counts[upd, None] + sums[upd]
            ) / new_counts[upd, None]
            counts = new_counts
            assignments[start + np.nonzero(assign_mask)[0]] = aidx

        for off in np.nonzero(create_mask)[0]:
            row = Xb[off].astype(np.float64)
            d2 = np.sum((cents[:ncent] - row) ** 2, axis=1)
            bi = int(np.argmin(d2))
            bd = float(d2[bi])
            if ncent < max_clusters and bd > radius * CREATE_FACTOR:
                cents[ncent] = row
                counts[ncent] = 1
                assignments[start + off] = ncent
                ncent += 1
            elif bd <= radius:
                counts[bi] += 1
                cents[bi] += (row - cents[bi]) / counts[bi]
                assignments[start + off] = bi
            elif bd <= radius * RELAX_FACTOR:
                counts[bi] += 1
                assignments[start + off] = bi

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


def nearest_centroid(row: np.ndarray, centroids: np.ndarray) -> tuple[int, float]:
    """(index, squared distance) of the nearest centroid, in float64."""
    d2 = np.sum((np.asarray(centroids, np.float64) - np.asarray(row, np.float64)) ** 2, axis=1)
    i = int(np.argmin(d2))
    return i, float(d2[i])
