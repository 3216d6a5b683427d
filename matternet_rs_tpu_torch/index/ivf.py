"""IVF-pruned λ-aware search (twin of the reference's ``index/ivf.py``).

The build's clustering buckets the items: each query ranks the buckets by
an upper bound of the blended score (``α·cos(query, centroid) + (1−α)·``
the best λ-proximity inside the bucket's λ interval), gathers the rows of
its best ``nprobe`` buckets and scores them exactly. A cluster larger than
``bucket_size`` spans several buckets, each with the cluster's centroid;
members are sorted by λ first, so each bucket's λ interval is tight. With
``nprobe`` at the bucket count every item is scored (the full scan, with
ties ordered by bucket position).

The reference maps one query at a time; here the batch runs at once, and
the ``[b, nprobe·bucket_size, F]`` row gather goes in query blocks of at
most ``GATHER_ELEMS`` elements (:func:`gather_block_queries`). Bucket and
candidate selections are :func:`..ops.search.topk_stable` (``lax.top_k``'s
order, ties lowest index first); the products are full f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from matternet_rs_tpu_torch.backend import resolve_device
from matternet_rs_tpu_torch.ops._mm import mm
from matternet_rs_tpu_torch.ops.kernels.tilemax import blend
from matternet_rs_tpu_torch.ops.search import _guarded_cosine, topk_stable

DEFAULT_BUCKET_SIZE = 1024
# Elements of one query block's candidate-row gather (1 GiB of float32).
GATHER_ELEMS = 1 << 28
# Rows of one chunk of the nearest-centroid pass.
ASSIGN_CHUNK = 65_536


@dataclasses.dataclass
class IVFIndex:
    """Bucketed cluster layout over an item store, on the store's device."""

    centroids: torch.Tensor         # [C, F] cluster means
    centroid_norms: torch.Tensor    # [C]
    bucket_items: torch.Tensor      # [NB, bucket_size] int64 item ids, -1 padding
    bucket_centroid: torch.Tensor   # [NB] int64 owning cluster
    bucket_lambda_lo: torch.Tensor  # [NB] least member λ (0 without λ)
    bucket_lambda_hi: torch.Tensor  # [NB] largest member λ (1 without λ)
    bucket_size: int
    n_clusters: int
    n_items: int

    @property
    def n_buckets(self) -> int:
        return int(self.bucket_items.shape[0])


def _segment_means(X_pref: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Means of the rows of each cluster id ≥ 0 that has rows, in float64
    summed row by row in row order (as ``np.add.at`` sums), as float32."""
    valid = a >= 0
    if not valid.any():
        raise ValueError("assignments contain no valid cluster ids")
    av = a[valid]
    order = np.argsort(av, kind="stable")
    rows = X_pref[valid][order].astype(np.float64)
    _, starts = np.unique(av[order], return_index=True)
    sums = np.add.reduceat(rows, starts, axis=0)
    counts = np.diff(np.append(starts, len(av))).astype(np.float64)
    return (sums / counts[:, None]).astype(np.float32)


def nearest_centroids(X: torch.Tensor, cents: torch.Tensor, chunk: int = ASSIGN_CHUNK) -> torch.Tensor:
    """Nearest centroid of every row by ``‖x‖² + ‖c‖² − 2⟨x, c⟩`` (full-f32
    product), in row chunks; ties take the first centroid."""
    c_sq = torch.sum(cents * cents, dim=-1)[None, :]
    out = []
    for s in range(0, X.shape[0], chunk):
        Xb = X[s:s + chunk]
        d = torch.sum(Xb * Xb, dim=-1, keepdim=True) + c_sq - 2.0 * mm(Xb, cents.T)
        out.append(torch.argmin(d, dim=1))
    return torch.cat(out)


def build_ivf(data, assignments: np.ndarray | None = None, n_clusters: int | None = None,
              bucket_size: int = DEFAULT_BUCKET_SIZE, seed: int = 0,
              lambdas: np.ndarray | None = None, device=None) -> IVFIndex:
    """Build the bucketed layout. With ``assignments`` (which may cover a
    prefix of the rows: rows appended after the build) the centroids are
    the means of the assigned rows; otherwise k-means++ and Lloyd
    (``n_clusters``, default ``max(2, √N)``). Every row, ``-1`` outliers
    included, then goes to its nearest centroid on the device, so every
    item is reachable. ``lambdas`` (the normalised λ) sort each cluster's
    members and set each bucket's λ interval. ``data`` is a tensor (its
    device) or an array (``device``; ``None`` is the card)."""
    from matternet_rs_tpu_torch.clustering import kmeans_lloyd

    if isinstance(data, torch.Tensor):
        X = data.to(torch.float32)
    else:
        X = torch.from_numpy(np.array(data, np.float32)).to(resolve_device(device))
    n = int(X.shape[0])
    if assignments is not None and len(assignments) > n:
        raise ValueError(f"assignments length {len(assignments)} exceeds data rows {n}")
    if assignments is not None:
        a = np.asarray(assignments)
        cents = _segment_means(X[:len(a)].cpu().numpy(), a)
    else:
        if n_clusters is None:
            n_clusters = max(2, int(np.sqrt(n)))
        _, cents = kmeans_lloyd(X, n_clusters, seed=seed)
        cents = np.asarray(cents, np.float32)

    cents_d = torch.from_numpy(cents).to(X.device)
    assign = nearest_centroids(X, cents_d).cpu().numpy()

    lam_np = None if lambdas is None else np.asarray(lambdas, np.float64)
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=cents.shape[0])
    buckets, owners, lam_lo, lam_hi = [], [], [], []
    pos = 0
    for cid, cnt in enumerate(counts):
        members = order[pos:pos + cnt]
        pos += cnt
        if lam_np is not None and cnt:
            members = members[np.argsort(lam_np[members], kind="stable")]
        # An empty cluster gets no bucket.
        for s in range(0, int(cnt), bucket_size):
            part = members[s:s + bucket_size]
            padded = np.full(bucket_size, -1, np.int64)
            padded[:len(part)] = part
            buckets.append(padded)
            owners.append(cid)
            lam_lo.append(float(lam_np[part].min()) if lam_np is not None else 0.0)
            lam_hi.append(float(lam_np[part].max()) if lam_np is not None else 1.0)

    dev = X.device
    return IVFIndex(
        centroids=cents_d,
        centroid_norms=torch.sqrt(torch.sum(cents_d * cents_d, dim=-1)),
        bucket_items=torch.from_numpy(np.stack(buckets)).to(dev),
        bucket_centroid=torch.as_tensor(owners, dtype=torch.int64, device=dev),
        bucket_lambda_lo=torch.as_tensor(np.asarray(lam_lo, np.float32), device=dev),
        bucket_lambda_hi=torch.as_tensor(np.asarray(lam_hi, np.float32), device=dev),
        bucket_size=bucket_size,
        n_clusters=int(cents.shape[0]),
        n_items=n,
    )


def gather_block_queries(n_cand: int, f: int, gather_elems: int = GATHER_ELEMS) -> int:
    """Queries per block of the candidate-row gather: the block's
    ``[b, n_cand, f]`` rows stay within ``gather_elems`` elements."""
    return max(1, gather_elems // max(n_cand * f, 1))


def _pruned_scores(ivf: IVFIndex, X, norms, lambdas, Q, q_lams, alphas, nprobe: int,
                   gather_elems: int):
    """Candidate ids ``[B, nb·bucket_size]`` (−1 padding) and their blended
    scores (−inf on padding) for a batch of queries."""
    qn = torch.sqrt(torch.sum(Q * Q, dim=-1))
    cscore = _guarded_cosine(mm(Q, ivf.centroids.T), ivf.centroid_norms[None, :] * qn[:, None])
    ql = q_lams[:, None]
    gap = torch.clamp(torch.maximum(ivf.bucket_lambda_lo[None, :] - ql,
                                    ql - ivf.bucket_lambda_hi[None, :]), min=0.0)
    a = alphas[:, None]
    bscore = a * cscore[:, ivf.bucket_centroid] + (1.0 - a) * (1.0 - torch.clamp(gap, max=1.0))
    nb = min(nprobe, ivf.n_buckets)
    _, bidx = topk_stable(bscore, nb)
    cand = ivf.bucket_items[bidx].reshape(Q.shape[0], -1)                 # [B, P]
    mask = cand >= 0
    safe = torch.clamp(cand, min=0)
    blk = gather_block_queries(cand.shape[1], X.shape[1], gather_elems)
    parts = []
    for s in range(0, Q.shape[0], blk):
        idx = safe[s:s + blk]
        dots = torch.bmm(X[idx], Q[s:s + blk, :, None])[..., 0]           # [b, P]
        parts.append(blend(dots, norms[idx] * qn[s:s + blk, None], lambdas[idx],
                           q_lams[s:s + blk, None], alphas[s:s + blk, None]))
    scores = torch.cat(parts)
    return cand, torch.where(mask, scores, torch.full_like(scores, -float("inf")))


def ivf_search_batch(ivf: IVFIndex, X, norms, lambdas, queries, query_lambdas, k: int,
                     alpha=0.7, nprobe: int = 8, gather_elems: int | None = None):
    """Pruned blended top-k for a batch: ``(indices [B, k], scores [B, k])``,
    global ids; a slot past the candidates holds −1 and −inf. The row
    gather's cap is ``GATHER_ELEMS`` unless ``gather_elems`` is given."""
    gather_elems = GATHER_ELEMS if gather_elems is None else gather_elems
    Q = queries.to(torch.float32)
    ql = torch.as_tensor(query_lambdas, dtype=torch.float32, device=Q.device).reshape(-1)
    a = torch.as_tensor(alpha, dtype=torch.float32, device=Q.device)
    a = a.expand(Q.shape[0]).contiguous() if a.ndim == 0 else a
    cand, scores = _pruned_scores(ivf, X, norms, lambdas, Q, ql, a, nprobe, gather_elems)
    top, ti = topk_stable(scores, min(k, cand.shape[1]))
    return torch.gather(cand, 1, ti), top


def ivf_search(ivf: IVFIndex, X, norms, lambdas, query, query_lambda, k: int,
               alpha: float = 0.7, nprobe: int = 8):
    """One query: ``(indices [k], scores [k])``."""
    idx, top = ivf_search_batch(ivf, X, norms, lambdas, query[None, :],
                                torch.as_tensor([float(query_lambda)]), k, alpha, nprobe)
    return idx[0], top[0]
