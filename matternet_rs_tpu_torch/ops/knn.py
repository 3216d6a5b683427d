"""Chunked top-k nearest rows (twin of the reference's ``ops/knn.py``).

One ``[chunk, N]`` distance product per block of queries and a top-k of
each block; no ``[N, N]`` buffer. The reference selects with ``lax.top_k``
outside any Pallas kernel, so ``torch.topk`` stands in (its order among
exactly equal distances is not fixed).
"""

from __future__ import annotations

import torch

from matternet_rs_tpu_torch.ops import distance as dist_ops
from matternet_rs_tpu_torch.ops._mm import mm


def knn(queries: torch.Tensor, corpus: torch.Tensor, k: int, metric: str = "rect_cosine",
        query_chunk: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest corpus rows per query: ``(dists [Q, k] ascending,
    idx [Q, k])``. ``rect_cosine`` is ``1 − max(cos, 0)``; any other
    metric name is the squared euclidean distance of the expanded form,
    floored at 0, and ``euclidean`` its square root."""
    queries = queries.to(torch.float32)
    corpus = corpus.to(torch.float32)
    if metric == "rect_cosine":
        corpus_t = dist_ops.normalize_rows(corpus).T
    else:
        corpus_t = corpus.T
        corpus_sq = torch.sum(corpus * corpus, dim=-1)[None, :]
    chunk = max(1, min(query_chunk, queries.shape[0]))
    dists, idx = [], []
    for s in range(0, queries.shape[0], chunk):
        q = queries[s:s + chunk]
        if metric == "rect_cosine":
            d = 1.0 - torch.clamp(mm(dist_ops.normalize_rows(q), corpus_t), min=0.0)
        else:
            q_sq = torch.sum(q * q, dim=-1, keepdim=True)
            d = torch.clamp(q_sq + corpus_sq - 2.0 * mm(q, corpus_t), min=0.0)
            if metric == "euclidean":
                d = torch.sqrt(d)
        neg, i = torch.topk(-d, k, dim=1)
        dists.append(-neg)
        idx.append(i)
    return torch.cat(dists), torch.cat(idx)
