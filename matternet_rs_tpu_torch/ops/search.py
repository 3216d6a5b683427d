"""λ-aware search (twin of the reference's ``ops/search.py``): the exact
routes and the rescored (maxima-first) route.

Score = α·cos + (1-α)·(1 - min(|λ - λq|, 1)) with the zero-norm-guarded
cosine. Exact routes, with the reference's thresholds:

* flat — all ``[B, N]`` scores, then top-k;
* tile-max (``N >= TILEMAX_MIN_N``) — per-tile maxima prune the top-k to a
  few candidate tiles (:func:`tilemax_topk`);
* fused (``N >= FUSED_TILEMAX_MIN_N`` when :func:`fused_fast_path` holds) —
  kernel B writes the scores and the sub-tile maxima in one pass; one
  launch selects the sub-tiles and ranks their scores and the ragged tail
  (``k ≤ 128``), or kernel C gathers the selected sub-tiles for the
  selection chain (:func:`fused_tilemax`).

Rescored route (:func:`fused_scan_rescored`, where
:func:`fused_rescored_path` holds): kernel D scans at reduced precision and
keeps only 128-row sub-tile maxima, kernel E dots every row of the selected
slabs at full precision, and the final top-k ranks exact scores only.

On the CPU the same routes run with the kernels' plain versions.

``approx=True``: the reference selects with ``lax.approx_max_k``, a TPU
operation. The port selects exactly instead (a stable top-k, or
:func:`tilemax_topk` where the reference's exact branch would), which is
what XLA itself does off the TPU: on the CPU ``approx_max_k`` returns
``lax.top_k``'s ids, ties lowest index first.

Tie order: ``lax.top_k`` returns ties lowest index first and the selection
relies on it; ``torch.topk`` promises no tie order, so every top-k here is
a stable descending sort (:func:`topk_stable`).
"""

from __future__ import annotations

import numpy as np
import torch

from matternet_rs_tpu_torch.ops import scores as score_ops
from matternet_rs_tpu_torch.ops._mm import mm, mm_bf16
from matternet_rs_tpu_torch.ops.kernels import rescored as rsk
from matternet_rs_tpu_torch.ops.kernels import tilemax as tmk

TILEMAX_MIN_N = 65_536
FUSED_TILEMAX_MIN_N = 32_768
DEFAULT_TILE = 2048
# The reference's fused-producer envelope (queries per batch, feature width).
MIN_FUSED_B = 2
MAX_FUSED_B = 1024
MAX_FUSED_F = 2048
SELECT_MARGIN = 4
# Selection granularity of the rescored tiers (128-row slabs at the
# default tile) and their slab-count cap, as in the reference.
RESCORE_SUBS = 16
MAX_RESCORE_SLABS = 64
# Cosine above which the hybrid search keeps a row whatever its λ.
SEMANTIC_THRESHOLD = 0.9999


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` semantics along the last dim: values descending, exact
    ties lowest index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def mask_rows(scores: torch.Tensor, mask_from: int | None, ids=None) -> torch.Tensor:
    """``scores`` with -inf wherever the row id is ≥ ``mask_from``: the
    padded rows of a mesh slot. ``ids`` (broadcast against ``scores``)
    defaults to the column index; ``None`` masks nothing."""
    if mask_from is None:
        return scores
    if ids is None:
        ids = torch.arange(scores.shape[-1], device=scores.device)
    return torch.where(ids < mask_from, scores, torch.full_like(scores, -float("inf")))


def _tilemax_degenerate(n: int, kk: int, t: int, margin: int = SELECT_MARGIN) -> bool:
    """True when the candidate set would cover the whole corpus."""
    nt0 = n // t
    return min(nt0, kk + margin) * t + (n - nt0 * t) >= n


def _fused_envelope(n: int, f: int, b: int, f32: bool, tile: int, cuda: bool) -> bool:
    if not f32 or n < tile or f > MAX_FUSED_F:
        return False
    if b < MIN_FUSED_B or b > MAX_FUSED_B or tile % tmk.SUBS:
        return False
    return not cuda or tile // tmk.SUBS == tmk.KERNEL_TS


def fused_supported(X: torch.Tensor, b: int, tile: int) -> bool:
    """Whether the fused producer applies: an f32 corpus of at least one
    tile, the reference's B and F envelope, and — for a CUDA corpus —
    kernel B's fixed sub-tile width."""
    n, f = X.shape
    return _fused_envelope(n, f, b, X.dtype == torch.float32, tile, X.is_cuda)


def _is_float32(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    return np.dtype(dtype) == np.float32


def fused_fast_path(n: int, f: int, b: int, dtype, kk: int, tile: int = DEFAULT_TILE, *,
                    device=None) -> bool:
    """Predicate for routing exact batched scans of an ``[n, f]`` corpus of
    ``dtype`` (torch or numpy) through the fused path from
    ``FUSED_TILEMAX_MIN_N``: producer envelope and non-degenerate
    selection; a CUDA ``device`` adds kernel B's sub-tile width. (The
    reference also needed a TPU and its DMA gather's B % 8 rule; kernel C
    takes any B.)"""
    cuda = device is not None and torch.device(device).type == "cuda"
    return not _tilemax_degenerate(n, kk, tile) and _fused_envelope(
        n, f, b, _is_float32(dtype), tile, cuda)


def _scan_dots_batch(X, queries) -> torch.Tensor:
    """Corpus dots ``[B, N]``: one bf16 pass for a bf16 corpus (the
    ``quantized=True`` copy), full f32 otherwise."""
    if X.dtype == torch.bfloat16:
        return mm_bf16(queries, X.T)
    return mm(queries, X.T)


def _batched_scores(X, norms, lambdas, queries, query_lambdas, alphas) -> torch.Tensor:
    """Blended score matrix ``[B, N]``; ``alphas`` scalar or ``[B]``."""
    qn = torch.sqrt(torch.sum(queries * queries, dim=-1))
    a = score_ops.alpha_vector(alphas, queries.shape[0], queries.device)
    return tmk.blended_scores(_scan_dots_batch(X, queries), norms, lambdas, qn,
                              query_lambdas, a)


def flat_topk(X, norms, lambdas, queries, query_lambdas, k: int, alphas,
              mask_from: int | None = None):
    """Flat exact top-k of ``queries [B, F]``; rows ≥ ``mask_from`` score
    -inf. Returns ``(indices [B, k], scores [B, k])``."""
    scores = mask_rows(_batched_scores(X, norms, lambdas, queries, query_lambdas, alphas),
                       mask_from)
    top, idx = topk_stable(scores, min(k, X.shape[0]))
    return idx, top


def search_lambda_aware(X, norms, lambdas, queries, query_lambdas, k: int,
                        alphas=0.7, approx: bool = False, recall_target: float = 0.95):
    """Flat exact top-k. ``queries [B, F]`` (or one ``[F]`` query with a
    scalar λ). ``approx`` selects exactly (module docstring), so
    ``recall_target``, the reference's bound for ``lax.approx_max_k``, is
    accepted and has nothing to bound. Returns ``(indices, scores)``,
    ``[B, k]`` or ``[k]``."""
    single = queries.ndim == 1
    Q = queries[None, :] if single else queries
    ql = torch.as_tensor(query_lambdas, dtype=torch.float32, device=Q.device).reshape(-1)
    idx, top = flat_topk(X, norms, lambdas, Q, ql, k, alphas)
    return (idx[0], top[0]) if single else (idx, top)


def _scan_dots(X, query) -> torch.Tensor:
    """Corpus·query dots ``[N]``: bf16 operands with f32 sums for a bf16
    corpus, full f32 otherwise."""
    if X.dtype == torch.bfloat16:
        return mm_bf16(X, query)
    return mm(X, query)


def cosine_scores(X, norms, query) -> torch.Tensor:
    """Cosine of ``query`` against every row (0 for zero norms)."""
    qn = torch.sqrt(torch.sum(query * query))
    return score_ops.guarded_cosine(_scan_dots(X, query), norms * qn)


def lambda_aware_scores(X, norms, lambdas, query, query_lambda, alpha) -> torch.Tensor:
    """Blended score of one query against every row."""
    qn = torch.sqrt(torch.sum(query * query))
    return tmk.blend(_scan_dots(X, query), norms * qn, lambdas, query_lambda, alpha)


def search_lambda_aware_hybrid(X, norms, lambdas, query, query_lambda, k: int, alpha=0.7):
    """Hybrid top-k of one query: the candidates are the blended top-k, the
    rows with cosine above ``SEMANTIC_THRESHOLD`` and the cosine's first
    argmax; high-cosine members score their cosine, the argmax outside
    both sets its cosine, the rest their blend; others −inf. Returns
    ``(indices [k], scores [k])``, ties lowest index first."""
    n = X.shape[0]
    kk = min(k, n)
    qn = torch.sqrt(torch.sum(query * query))
    cos = score_ops.guarded_cosine(_scan_dots(X, query), norms * qn)
    lambda_score = score_ops.blend(cos, lambdas, query_lambda, alpha)
    _, top_idx = topk_stable(lambda_score, kk)
    in_topk = torch.zeros(n, dtype=torch.bool, device=X.device)
    in_topk[top_idx] = True
    high_sem = cos > SEMANTIC_THRESHOLD
    is_sem_top = torch.zeros(n, dtype=torch.bool, device=X.device)
    is_sem_top[torch.argmax(cos)] = True
    eligible = in_topk | high_sem | is_sem_top
    final = torch.where(high_sem, cos, lambda_score)
    final = torch.where(is_sem_top & ~high_sem & ~in_topk, cos, final)
    final = torch.where(eligible, final, torch.full_like(final, -float("inf")))
    top, idx = topk_stable(final, kk)
    return idx, top


def search_lambda_banded(X, norms, sorted_lambdas, sorted_indices, query, query_lambda,
                         k: int, alpha=0.7, window: int = 4096):
    """Blended top-k of one query over a window of ``window`` rows of the
    sorted-λ order centred on the query's position (``searchsorted``, left
    side), clipped to the corpus; full-f32 dots. Approximate: rows outside
    the window cannot be returned. Returns global ``(indices, scores)``."""
    n = X.shape[0]
    w = min(window, n)
    q_lam = torch.as_tensor([float(query_lambda)], dtype=sorted_lambdas.dtype,
                            device=sorted_lambdas.device)
    pos = int(torch.searchsorted(sorted_lambdas, q_lam)[0])
    start = min(max(pos - w // 2, 0), n - w)
    cand = sorted_indices[start:start + w].long()
    cand_lam = sorted_lambdas[start:start + w]
    qn = torch.sqrt(torch.sum(query * query))
    scores = tmk.blend(mm(X[cand], query), norms[cand] * qn, cand_lam, q_lam[0], alpha)
    top, idx = topk_stable(scores, min(k, w))
    return cand[idx], top


def range_search_mask(lambdas, query_lambda, eps):
    """Signed λ distance ``λq − λi`` and the mask ``λq − λi ≤ eps``, in
    float32 (scalars are taken at the λ's dtype)."""
    dist = query_lambda - lambdas
    return dist, dist <= eps


# The selection chain, in one copy beside the kernel that replaces it.
_tilemax_select = tmk.select_topk_plain


def tilemax_topk(scores: torch.Tensor, k: int, tile: int = DEFAULT_TILE,
                 margin: int = SELECT_MARGIN):
    """Exact top-k over ``scores [B, N]`` via tile-max pruned selection:
    keep the ``k + margin`` tiles with the largest maxima (every item above
    the k-th score lives in one of them), top-k among those tiles and the
    ragged tail. Returns ``(scores [B, k], indices [B, k])``."""
    b, n = scores.shape
    kk = min(k, n)
    t = min(tile, n)
    nt0 = n // t
    n0 = nt0 * t
    if _tilemax_degenerate(n, kk, t, margin):
        return topk_stable(scores, kk)
    main = scores[:, :n0].reshape(b, nt0, t)
    tail = scores[:, n0:] if n0 < n else None
    return _tilemax_select(main, main.amax(dim=2), tail, n, kk, margin)


def search_lambda_aware_tilemax(X, norms, lambdas, queries, query_lambdas, k: int,
                                alphas, tile: int = DEFAULT_TILE, mask_from: int | None = None):
    """Exact batched top-k with tile-max selection; the fused producer when
    it applies. Rows ≥ ``mask_from`` score -inf. Returns ``(indices
    [B, k], scores [B, k])``."""
    b, n = queries.shape[0], X.shape[0]
    kk = min(k, n)
    t = min(tile, n)
    if not _tilemax_degenerate(n, kk, t) and fused_supported(X, b, t):
        top, idx = fused_tilemax(X, norms, lambdas, queries, query_lambdas, kk, alphas, t,
                                 mask_from=mask_from)
        return idx, top
    scores = mask_rows(_batched_scores(X, norms, lambdas, queries, query_lambdas, alphas),
                       mask_from)
    top, idx = tilemax_topk(scores, k, tile=tile)
    return idx, top


def fused_tilemax(X, norms, lambdas, queries, query_lambdas, kk: int, alphas,
                  t: int = DEFAULT_TILE, mask_from: int | None = None,
                  producer=tmk.scores_and_tilemax, gather=tmk.gather_subtiles,
                  select=tmk.select_topk):
    """Fused-producer tile-max top-k: kernel B for the scores and sub-tile
    maxima, the ragged tail scored by :func:`_batched_scores`, then
    ``select`` at sub-tile granularity — on the card the candidate stage in
    one launch for ``kk ≤ 128``, the selection chain with kernel C as its
    ``gather`` beyond. ``producer``, ``gather`` and ``select`` default to
    the kernel wrappers; passing their plain versions runs the same path
    without the kernels (a comparison run; ``select=tmk.select_topk_plain``
    alone takes the selection chain with kernel C). Rows ≥ ``mask_from``
    score -inf. Returns ``(top [B, kk], idx [B, kk])``."""
    b, n = queries.shape[0], X.shape[0]
    nt0 = n // t
    n0 = nt0 * t
    a = score_ops.alpha_vector(alphas, b, queries.device)
    smain, submax = producer(
        X, norms, lambdas, queries, query_lambdas, a, tile=t, mask_from=mask_from
    )
    tail = None
    if n0 < n:
        tail = mask_rows(_batched_scores(X[n0:], norms[n0:], lambdas[n0:], queries,
                                         query_lambdas, a),
                         mask_from, torch.arange(n0, n, device=X.device))
    ts = t // tmk.SUBS
    ns = nt0 * tmk.SUBS
    return select(
        smain.view(b, ns, ts), submax, tail, n, kk, SELECT_MARGIN,
        gather=lambda sel: gather(smain, sel, ts),
    )


def tilemax_only_supported(n: int, f: int, b: int, tile: int, subs: int = tmk.SUBS) -> bool:
    """Envelope of the maxima-first producer: at least one tile, the
    reference's B and F limits, sub-tiles of whole 128-row chunks. The
    reference's VMEM budget and TPU-platform clauses have no counterpart:
    kernel D stages 32 features and 64 queries at a time, so its shared
    memory does not grow with F or B."""
    return (
        n >= tile and f <= MAX_FUSED_F
        and MIN_FUSED_B <= b <= MAX_FUSED_B
        and tile % (subs * rsk.KERNEL_CHUNK) == 0
    )


def _slab_budget(kk: int, cand: int, ts: int) -> int:
    """Slabs of ``ts`` rows the rescored selection keeps (before the corpus caps them)."""
    return max(kk + SELECT_MARGIN, -(-cand // ts))


def fused_rescored_path(n: int, f: int, b: int, kk: int, cand: int,
                        tile: int = DEFAULT_TILE) -> bool:
    """Routing predicate for :func:`fused_scan_rescored`: the producer's
    envelope, a corpus large enough for sub-tile pruning to pay, a
    non-degenerate selection, and a slab rescore that stays a small part
    of the corpus (a huge ``candidates`` takes the pool-cut fallback). The
    reference's ``b % 8 == 0`` and ``f % 128 == 0`` clauses were Mosaic
    rules (the slab ring's 8-query blocks, the DMA's 128-lane slices);
    kernels D and E take any B and F, so they are dropped."""
    ts = tile // RESCORE_SUBS
    c = _slab_budget(kk, cand, ts)
    return (
        n >= FUSED_TILEMAX_MIN_N
        and not _tilemax_degenerate(n, kk, tile)
        and tilemax_only_supported(n, f, b, tile, subs=RESCORE_SUBS)
        and c <= MAX_RESCORE_SLABS
        and c * ts * 8 <= n
    )


def _slab_dots_checked(X, queries, sel, ts: int):
    """Kernel E on slab ids that :func:`maxfirst_slabs` made itself, in
    ``[0, ns)`` by construction: the wrapper skips its range check and so
    reads nothing back to the host (a bad id would still show, as a NaN
    slice)."""
    return rsk.slab_dots(X, queries, sel, ts, checked=True)


def maxfirst_slabs(Xscan, X, norms, lambdas, queries, query_lambdas, alphas, kk: int,
                   cand: int, t: int, scan_rn, mask_from, producer, slab_reader):
    """The maxima-first slab choice of the rescored tiers
    (:func:`fused_scan_rescored`) and of the resident sketch
    (``index/streaming._sketch_maxfirst_topk``). ``producer`` (kernel D)
    scans ``Xscan`` — bf16, int8 (with ``scan_rn`` its dequant multiplier)
    or f32 (bf16x3) — and returns only the maxima ``[B, ns]`` of its
    ``ts = t // RESCORE_SUBS``-row sub-tiles, rows ≥ ``mask_from`` at -inf;
    the ``c = min(ns, max(kk + 4, ⌈cand/ts⌉))`` sub-tiles with the largest
    maxima, in id order, go to ``slab_reader`` (kernel E, told the ids are
    in range: nothing is read back) for the dots of their rows of ``X``.
    Returns those dots, the rows' ``norms`` and ``lambdas`` (``[B, c, ts]``)
    and ids ``[B, c·ts]``."""
    ts = t // RESCORE_SUBS
    ns = (Xscan.shape[0] // t) * RESCORE_SUBS
    submax = producer(Xscan, norms, lambdas, queries, query_lambdas, alphas, tile=t,
                      subs=RESCORE_SUBS, mask_from=mask_from, rn=scan_rn)
    sel = torch.sort(topk_stable(submax, min(ns, _slab_budget(kk, cand, ts)))[1], dim=1).values
    d = slab_reader(X, queries, sel, ts)
    ids = sel[:, :, None] * ts + torch.arange(ts, device=sel.device)
    return d, norms[:ns * ts].view(ns, ts)[sel], lambdas[:ns * ts].view(ns, ts)[sel], ids.flatten(1)


def fused_scan_rescored(Xscan, X, norms, lambdas, queries, query_lambdas, k: int,
                        cand: int, alphas, t: int = DEFAULT_TILE, scan_rn=None,
                        mask_from: int | None = None,
                        producer=rsk.tilemax_only, slab_reader=_slab_dots_checked):
    """Maxima-first reduced-precision scan + exact slab rescore: the slabs
    of :func:`maxfirst_slabs`, their rows of the f32 corpus ``X`` blended at
    full f32, the ragged tail scored exactly by :func:`_batched_scores`; the
    final stable top-k ranks exact scores only, ties lowest index first.
    Rows ≥ ``mask_from`` score -inf at both stages. Passing the plain
    versions as ``producer``/``slab_reader`` runs the same path without
    the kernels. Caller checks :func:`fused_rescored_path`. Returns
    ``(idx [B, kk], scores [B, kk])``."""
    b, n = queries.shape[0], X.shape[0]
    kk = min(k, n)
    n0 = (n // t) * t
    a = score_ops.alpha_vector(alphas, b, queries.device)
    d, nrm_s, lam_s, gidx = maxfirst_slabs(Xscan, X, norms, lambdas, queries, query_lambdas, a,
                                           kk, cand, t, scan_rn, mask_from, producer, slab_reader)
    qn = torch.sqrt(torch.sum(queries * queries, dim=-1))
    s = tmk.blend(d, nrm_s * qn[:, None, None], lam_s, query_lambdas[:, None, None],
                  a[:, None, None]).flatten(1)
    if n0 < n:
        tail = _batched_scores(X[n0:], norms[n0:], lambdas[n0:], queries, query_lambdas, a)
        s = torch.cat([s, tail], dim=1)
        gidx = torch.cat([gidx, torch.arange(n0, n, device=gidx.device).expand(b, n - n0)], dim=1)
    top, pos = topk_stable(mask_rows(s, mask_from, gidx), kk)
    return torch.gather(gidx, 1, pos), top
