"""Cosine-kernel kNN graph Laplacian (twin of the reference's
``ops/laplacian.py``): the dense build and, from ``DIRECT_ELL_N`` nodes,
the direct ELL build that never forms ``[n, n]``.

Steps, as in the reference: optional column standardisation, rectified
cosine kNN with self excluded, kernel weights ``1/(1+(d/σ)^p)``, inline
degree sparsification when the mean degree exceeds 10, union
symmetrisation ``W = max(W, Wᵀ)``, then ``L = D - W`` (or ``L_sym``). The
direct build takes the kNN lists from ``[row_tile, n]`` distance strips and
symmetrises on the edge list (forward slots, then reverse-only edges from
the (destination, −weight)-sorted list), with O(n·k) memory throughout.

Tie order: the reference's ``lax.top_k`` and ``jnp.argsort`` break ties
lowest index first and its ``lexsort`` is stable; here every one is a
stable ``torch.sort``
(:func:`~matternet_rs_tpu_torch.ops.search.topk_stable`).
"""

from __future__ import annotations

import logging

import torch

from matternet_rs_tpu_torch.graph import GraphLaplacian, GraphParams
from matternet_rs_tpu_torch.ops import distance as dist_ops
from matternet_rs_tpu_torch.ops._mm import mm
from matternet_rs_tpu_torch.ops.csr import EllLaplacian
from matternet_rs_tpu_torch.ops.search import topk_stable

log = logging.getLogger(__name__)

WEIGHT_FLOOR = 1e-12
SPARSIFY_AVG_DEGREE = 10.0
# Node count from which build_laplacian_matrix takes the direct ELL build:
# memory O(n·k) plus one [DIRECT_ELL_ROW_TILE, n] distance strip.
DIRECT_ELL_N = 8192
DIRECT_ELL_ROW_TILE = 2048


def _degree_sparsify(w, idx, valid, vmask) -> torch.Tensor:
    """Inline sparsification of the directed candidate weights ``w [n, kk]``
    when the mean eps-valid degree exceeds ``SPARSIFY_AVG_DEGREE``: a row
    with more than two kept candidates keeps its best half by score
    ``w·√(deg_i·deg_j)`` (ties lowest slot first)."""
    degrees = valid.sum(dim=1)
    sparsify = degrees.to(torch.float32).mean() > SPARSIFY_AVG_DEGREE
    deg_f = degrees.to(torch.float32)
    score = w * torch.sqrt(deg_f[:, None] * deg_f[idx])
    score = torch.where(vmask, score, torch.full_like(score, -float("inf")))
    order = torch.argsort(-score, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    n_valid = vmask.sum(dim=1)
    keep_count = torch.where(
        n_valid > 2, torch.clamp(n_valid // 2, min=1), n_valid
    )
    keep_mask = ranks < keep_count[:, None]
    return torch.where(sparsify & ~keep_mask, torch.zeros_like(w), w)


def _adjacency_dense(
    nodes: torch.Tensor, eps: float, p: float, sigma: float, topk: int,
    normalise: bool,
) -> torch.Tensor:
    """Dense symmetric weighted adjacency ``W [n, n]`` from node profiles."""
    n = nodes.shape[0]
    f32 = dict(dtype=torch.float32, device=nodes.device)
    eps_t, p_t, sigma_t = (torch.tensor(v, **f32) for v in (eps, p, sigma))
    x = dist_ops.standardize_columns(nodes) if normalise else nodes

    d = dist_ops.rectified_cosine_distance(x)
    d.fill_diagonal_(float("inf"))

    kk = min(topk, n - 1)
    neg_d, idx = topk_stable(-d, kk)                # [n, kk]
    nd = -neg_d
    valid = nd <= eps_t

    w = 1.0 / (1.0 + (nd / sigma_t) ** p_t)
    vmask = valid & (w > WEIGHT_FLOOR)
    w = torch.where(vmask, w, torch.zeros_like(w))

    w = _degree_sparsify(w, idx, valid, vmask)

    W = torch.zeros((n, n), **f32).scatter_reduce(
        1, idx, w, reduce="amax", include_self=True
    )
    return torch.maximum(W, W.T)


def laplacian_from_adjacency(W: torch.Tensor) -> torch.Tensor:
    """Unnormalised ``L = D - W``."""
    return torch.diag(W.sum(dim=1)) - W


def sym_normalized_laplacian(W: torch.Tensor) -> torch.Tensor:
    """``L_sym = I - D^{-1/2} W D^{-1/2}`` with isolated nodes left as I."""
    deg = W.sum(dim=1)
    inv_sqrt = torch.where(
        deg > 0, 1.0 / torch.sqrt(torch.clamp(deg, min=1e-30)), torch.zeros_like(deg)
    )
    Wn = W * inv_sqrt[:, None] * inv_sqrt[None, :]
    return torch.eye(W.shape[0], dtype=W.dtype, device=W.device) - Wn


def _knn_dense_tiled(nodes: torch.Tensor, topk: int, normalise: bool, row_tile: int):
    """Exact rectified-cosine kNN with bounded memory: one ``[row_tile, n]``
    distance strip (a full-f32 product) at a time, each reduced to its
    stable top-``kk``. Returns ``(nd [n, kk], idx [n, kk] int32)`` with self
    excluded — the candidate lists ``_adjacency_dense`` takes from its
    ``[n, n]`` pass."""
    n = nodes.shape[0]
    x = dist_ops.standardize_columns(nodes) if normalise else nodes
    xhat = dist_ops.normalize_rows(x)
    kk = min(topk, n - 1)
    cols = torch.arange(n, device=nodes.device)
    nds, ids = [], []
    for r0 in range(0, n, row_tile):
        d = 1.0 - torch.clamp(mm(xhat[r0:r0 + row_tile], xhat.T), min=0.0)
        d[cols[r0:r0 + row_tile, None] == cols[None, :]] = float("inf")
        neg_d, idx = topk_stable(-d, kk)
        nds.append(-neg_d)
        ids.append(idx.to(torch.int32))
    return torch.cat(nds), torch.cat(ids)


def _ell_weights(nd, idx, eps, p, sigma):
    """Stage 1 of the direct build: eps filter, kernel weights, inline
    degree sparsification → directed weights and forward ids ``[n, kk]``
    (−1 where no edge). ``eps``, ``p``, ``sigma`` are f32 scalar tensors."""
    valid = nd <= eps
    w = 1.0 / (1.0 + (torch.where(valid, nd, torch.zeros_like(nd)) / sigma) ** p)
    vmask = valid & (w > WEIGHT_FLOOR)
    w = torch.where(vmask, w, torch.zeros_like(w))
    w = _degree_sparsify(w, idx.long(), valid, vmask)
    fwd_ids = torch.where(w > 0, idx, torch.full_like(idx, -1))
    return w, fwd_ids


def _ell_forward_sym(w, fwd_ids):
    """Stage 2: a forward slot takes ``max(w_ij, w_ji)`` where j also points
    at i. Also counts each row's mutual edges, for the exact dropped-edge
    accounting of stage 3."""
    n = w.shape[0]
    my_ids = torch.arange(n, dtype=torch.int32, device=w.device)
    nb = torch.clamp(fwd_ids, min=0).long()
    nb_rows = fwd_ids[nb]                                       # [n, kk, kk]
    nb_w = w[nb]
    rev_hit = (nb_rows == my_ids[:, None, None]) & (nb_w > 0)
    w_rev_fwd = torch.where(rev_hit, nb_w, torch.zeros_like(nb_w)).amax(dim=2)
    w_fwd = torch.where(fwd_ids >= 0, torch.maximum(w, w_rev_fwd), torch.zeros_like(w))
    n_mutual = (rev_hit.any(dim=2) & (w_fwd > 0)).sum(dim=1)
    return w_fwd, n_mutual


def _in_runs(dst_sorted, n: int):
    """``[lo, hi)`` of each node's run in the sorted destination list."""
    my_ids = torch.arange(n, dtype=dst_sorted.dtype, device=dst_sorted.device)
    return (torch.searchsorted(dst_sorted, my_ids, right=False),
            torch.searchsorted(dst_sorted, my_ids, right=True))


def _ell_reverse_required(fwd_ids, n_mutual):
    """Exact global reverse-slot requirement ``max_i(in_degree(i) −
    n_mutual(i))``, the accounting stage 3's ``dropped`` uses; stage 3 at
    this capacity drops nothing."""
    n = fwd_ids.shape[0]
    dst = fwd_ids.reshape(-1)
    dst_s = torch.sort(torch.where(dst >= 0, dst, torch.full_like(dst, n))).values
    lo, hi = _in_runs(dst_s, n)
    return torch.max((hi - lo) - n_mutual)


def _ell_reverse(w, fwd_ids, w_fwd, n_mutual, rk: int):
    """Stage 3: reverse-only (in-)edges from the directed edge list sorted
    by (destination, −weight): each node's run, minus the edges its forward
    slots already hold, capped at ``rk`` per row keeping the heaviest; the
    count of dropped edges is returned. Gives ``(ids [n, kk+rk] int32 with
    −1 for empty, weights, diag, dropped)``."""
    n, kk = w.shape
    dev = w.device
    my_ids = torch.arange(n, dtype=torch.int32, device=dev)
    src = my_ids.repeat_interleave(kk)
    dst = fwd_ids.reshape(-1)
    ew = w.reshape(-1)
    dst_key = torch.where(dst >= 0, dst, torch.full_like(dst, n))   # invalid → end
    # lexsort((-ew, dst_key)): by weight descending, then — stably — by key.
    by_w = torch.argsort(-ew, stable=True)
    edge_order = by_w[torch.argsort(dst_key[by_w], stable=True)]
    dst_s, src_s, ew_s = dst_key[edge_order], src[edge_order], ew[edge_order]

    rkx = rk + kk        # over-gather: ≤ kk run entries are forward duplicates
    lo, hi = _in_runs(dst_s, n)
    take = lo[:, None] + torch.arange(rkx, device=dev)[None, :]
    in_run = take < hi[:, None]
    take = torch.clamp(take, max=dst_s.shape[0] - 1)
    cand_src = torch.where(in_run, src_s[take], torch.full_like(take, -1, dtype=torch.int32))
    cand_w = torch.where(in_run, ew_s[take], torch.zeros((), device=dev))
    fwd_live = torch.where(w_fwd > 0, fwd_ids, torch.full_like(fwd_ids, -2))
    dup = (cand_src[:, :, None] == fwd_live[:, None, :]).any(dim=2)
    ok = in_run & ~dup & (cand_w > 0)
    rank = torch.cumsum(ok.to(torch.int64), dim=1) - 1
    keep = ok & (rank < rk)
    slot = torch.where(keep, rank, torch.full_like(rank, rk))       # rk = dump column
    rev_src = torch.full((n, rk + 1), -1, dtype=torch.int32, device=dev).scatter_reduce_(
        1, slot, torch.where(keep, cand_src, torch.full_like(cand_src, -1)),
        reduce="amax", include_self=True,
    )[:, :rk]
    rev_w = torch.zeros((n, rk + 1), dtype=torch.float32, device=dev).scatter_reduce_(
        1, slot, torch.where(keep, cand_w, torch.zeros_like(cand_w)),
        reduce="amax", include_self=True,
    )[:, :rk]
    dropped = torch.clamp((hi - lo) - n_mutual - rk, min=0).sum()

    ell_ids = torch.cat([torch.where(w_fwd > 0, fwd_ids, torch.full_like(fwd_ids, -1)),
                         rev_src], dim=1)
    ell_w = torch.cat([w_fwd, rev_w], dim=1)
    return ell_ids, ell_w, ell_w.sum(dim=1), dropped


def _ell_from_knn(nd, idx, eps, p, sigma, rk):
    """kNN candidate lists → symmetrised ELL adjacency and degree diagonal,
    with ``_adjacency_dense``'s semantics in O(n·k) memory.

    ``rk="auto"``: stage 3 runs at the default ``2·kk`` reverse slots and,
    if any reverse edge was dropped, once more at the exact global
    requirement (:func:`_ell_reverse_required`, capped at
    ``min(n-1, 64·kk)``); growth beyond the default is logged with the
    resulting ELL size, so a hub-heavy corpus cannot inflate the O(n·k)
    footprint unseen."""
    n, kk = idx.shape
    w, fwd_ids = _ell_weights(nd, idx, eps, p, sigma)
    w_fwd, n_mutual = _ell_forward_sym(w, fwd_ids)
    if rk != "auto":
        return _ell_reverse(w, fwd_ids, w_fwd, n_mutual, rk=int(rk))
    cap = min(n - 1, 64 * kk)
    rk_i = min(2 * kk, cap)
    out = _ell_reverse(w, fwd_ids, w_fwd, n_mutual, rk=rk_i)
    if int(out[3]) == 0 or rk_i >= cap:
        return out
    need = int(_ell_reverse_required(fwd_ids, n_mutual))
    rk_i = min(max(need, rk_i + 1), cap)
    est_gb = n * (kk + rk_i) * 8 / 1e9
    if need > cap:
        log.warning(
            "direct-ELL auto reverse capacity CAPPED at %d slots/row (exact union "
            "symmetrization needs %d > cap %d; weakest reverse edges will be "
            "dropped) — ELL ids+weights ≈ %.2f GB at n=%d; raise the cap via "
            "reverse_k for exactness", rk_i, need, cap, est_gb, n,
        )
    else:
        log.log(
            logging.WARNING if est_gb > 0.5 else logging.INFO,
            "direct-ELL auto reverse capacity grew to %d slots/row (default %d, "
            "cap %d) for exact union symmetrization — ELL ids+weights ≈ %.2f GB "
            "at n=%d; pin reverse_k to bound memory instead",
            rk_i, min(2 * kk, cap), cap, est_gb, n,
        )
    return _ell_reverse(w, fwd_ids, w_fwd, n_mutual, rk=rk_i)


def _check_nodes(nodes: torch.Tensor) -> None:
    if nodes.shape[0] < 2 or nodes.shape[1] < 2:
        raise ValueError(
            f"nodes should be at least of shape (2,2): {tuple(nodes.shape)}"
        )


def _checked_sparsity(gl: GraphLaplacian) -> GraphLaplacian:
    if gl.graph_params.sparsity_check:
        sp = gl.sparsity(tol=1e-12)
        if sp > 0.95:
            raise ValueError(f"Resulting laplacian matrix is too sparse {sp}")
    return gl


def build_laplacian_ell(
    nodes: torch.Tensor,
    params: GraphParams,
    n_items: int | None = None,
    energy: bool = False,
    normalized: bool = False,
    reverse_k: int | str | None = None,
    row_tile: int = DIRECT_ELL_ROW_TILE,
) -> GraphLaplacian:
    """Direct O(n·k)-memory graph build: tiled exact kNN → symmetrised ELL
    Laplacian, never forming ``[n, n]``. Equal to
    :func:`build_laplacian_matrix` when ``reverse_k`` covers the realised
    in-degrees. The default (``None`` = ``"auto"``) grows the reverse
    capacity from ``2·topk`` until no in-edge is dropped (capped at
    ``min(n-1, 64·topk)``); an int pins it, and dropped edges are then
    counted and logged. ``normalized=True`` yields ``L_sym`` in ELL form
    (diag 1, weights ``w/√(dᵢdⱼ)``)."""
    nodes = nodes.to(torch.float32)
    n = nodes.shape[0]
    _check_nodes(nodes)
    kk = min(int(params.topk), n - 1)
    rk = "auto" if reverse_k in (None, "auto") else int(reverse_k)
    nd, idx = _knn_dense_tiled(nodes, kk, bool(params.normalise), min(row_tile, n))
    f32 = dict(dtype=torch.float32, device=nodes.device)
    ell_ids, ell_w, diag, dropped = _ell_from_knn(
        nd, idx, *(torch.tensor(v, **f32) for v in
                   (float(params.eps), float(params.p), params.sigma_value())), rk=rk,
    )
    n_dropped = int(dropped)
    if n_dropped:
        log.warning(
            "build_laplacian_ell: %d reverse edges beyond the per-row capacity %s "
            "were dropped (weakest first); raise reverse_k for exact union "
            "symmetrization", n_dropped, ell_ids.shape[1] - kk,
        )
    if normalized:
        inv_sqrt = torch.where(
            diag > 0, 1.0 / torch.sqrt(torch.clamp(diag, min=1e-30)), torch.zeros_like(diag)
        )
        ell_w = ell_w * inv_sqrt[:, None] * inv_sqrt[torch.clamp(ell_ids, min=0).long()]
        ell_w = torch.where(ell_ids >= 0, ell_w, torch.zeros_like(ell_w))
        diag = torch.ones_like(diag)
    ell = EllLaplacian(indices=ell_ids.contiguous(), weights=ell_w.contiguous(), diag=diag)
    gl = GraphLaplacian.from_ell(
        ell, init_data=nodes, nnodes=n if n_items is None else int(n_items),
        graph_params=params, energy=energy,
    )
    return _checked_sparsity(gl)


def build_adjacency(nodes: torch.Tensor, params: GraphParams) -> torch.Tensor:
    return _adjacency_dense(
        nodes.to(torch.float32), float(params.eps), float(params.p),
        params.sigma_value(), int(params.topk), bool(params.normalise),
    )


def build_laplacian_matrix(
    nodes: torch.Tensor,
    params: GraphParams,
    n_items: int | None = None,
    energy: bool = False,
    normalized: bool = False,
) -> GraphLaplacian:
    """Laplacian over the rows of ``nodes [n, profile]``; ``normalized``
    gives ``L_sym``. From ``DIRECT_ELL_N`` nodes the result is ELL-backed
    (:func:`build_laplacian_ell`): the dense ``[n, n]`` intermediates are a
    memory wall there."""
    nodes = nodes.to(torch.float32)
    n = nodes.shape[0]
    _check_nodes(nodes)
    if n >= DIRECT_ELL_N:
        return build_laplacian_ell(
            nodes, params, n_items=n_items, energy=energy, normalized=normalized
        )
    W = build_adjacency(nodes, params)
    L = sym_normalized_laplacian(W) if normalized else laplacian_from_adjacency(W)
    return _checked_sparsity(GraphLaplacian(
        matrix=L,
        init_data=nodes,
        nnodes=n if n_items is None else int(n_items),
        graph_params=params,
        energy=energy,
    ))


def build_laplacian_from_k_cluster(
    centroids: torch.Tensor, params: GraphParams, n_items: int
) -> GraphLaplacian:
    """Feature-space ``F×F`` Laplacian from ``[C, F]`` centroids (graph
    nodes are features with C-length profiles)."""
    centroids = centroids.to(torch.float32)
    if centroids.shape[0] > n_items:
        raise ValueError("more centroids than items")
    return build_laplacian_matrix(centroids.T.contiguous(), params, n_items=n_items)


def build_spectral_laplacian(gl: GraphLaplacian, n_items: int) -> torch.Tensor:
    """Second-order "signals" Laplacian: the Laplacian over the rows of
    ``gl``'s matrix (densified if ELL-backed), with the same params."""
    return build_laplacian_matrix(
        gl.dense(), gl.graph_params, n_items=n_items
    ).dense()
