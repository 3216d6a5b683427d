"""The item graph over the mesh: ring kNN, the sharded ELL Laplacian and
distributed LOBPCG (twin of the reference's ``parallel/knn_graph.py``).

Each slot keeps its block of query rows; a visiting tile of corpus rows
goes round the ring (:func:`..mesh.ring_shift`, the ``ppermute`` step), so
a slot holds one remote tile at a time and the pairwise matrix exists
nowhere. After D steps every row has seen the whole corpus: exact, with
the (distance, id) order. On that kNN, :func:`distributed_knn_ell_laplacian`
applies the single-card recipe (eps filter, kernel weights, degree
sparsification decided on the global mean degree, union symmetrisation,
``L = D − W``) with the graph as row-sharded ELL; reverse edges are
recovered from the all-gathered edge list (an O(N·k) transient), rows past
their reverse capacity keep their heaviest reverse edges, and the dropped
count is reported. :func:`distributed_lobpcg` runs the single-card LOBPCG
with the row-sharded operator: each slot applies its rows through kernel F
(``d∘X − W@X`` against the replicated block, the rows form of
``spmv_ell``), and the slots' rows are gathered.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.ops import distance as dist_ops
from matternet_rs_tpu_torch.ops._mm import mm
from matternet_rs_tpu_torch.ops.eigensolver import _lobpcg_core
from matternet_rs_tpu_torch.ops.kernels import spmv_ell as fk
from matternet_rs_tpu_torch.ops.laplacian import SPARSIFY_AVG_DEGREE, WEIGHT_FLOOR
from matternet_rs_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedArray,
    all_gather,
    local_map,
    on_slot,
    psum,
    replicate,
    ring_shift,
    sharded,
)

log = logging.getLogger(__name__)

# Padded rows get this diagonal, so their eigenpairs sit at the top of the
# spectrum, far from the smallest ones the solver looks for.
PAD_DIAG = 1e6


def _standardize_global(mesh: Mesh, Xs: ShardedArray, n_items: int) -> ShardedArray:
    """Column z-scores with moments over the ``n_items`` real rows only
    (two ``psum``); padded rows stay zero."""
    per = Xs.per

    def mask_of(slot, Xl):
        return ((slot * per + torch.arange(per, device=Xl.device)) < n_items).to(Xl.dtype)[:, None]

    moments = local_map(mesh, lambda s, Xl: (torch.sum(Xl * mask_of(s, Xl), dim=0),
                                             torch.sum(Xl * Xl * mask_of(s, Xl), dim=0)), Xs)
    s1 = psum(mesh, [m[0] for m in moments])
    s2 = psum(mesh, [m[1] for m in moments])
    mean = s1 / n_items
    var = torch.clamp(s2 / n_items - mean * mean, min=0.0)
    std = torch.clamp(torch.sqrt(var), min=dist_ops.EPS_NORM)
    out = local_map(mesh, lambda s, Xl, mu, sd: (Xl - mu[None, :]) / sd[None, :] * mask_of(s, Xl),
                    Xs, replicate(mesh, mean), replicate(mesh, std))
    return sharded(mesh, out, Xs.shape)


def _merge_knn(best_d, best_i, d, ids, kk: int):
    """(distance, id) order: ids ascending first, then a stable sort by
    distance; the first ``kk``."""
    cat_d = torch.cat([best_d, d], dim=1)
    cat_i = torch.cat([best_i, ids], dim=1)
    o = torch.argsort(cat_i, dim=1, stable=True)
    cat_d, cat_i = torch.gather(cat_d, 1, o), torch.gather(cat_i, 1, o)
    sel = torch.argsort(cat_d, dim=1, stable=True)[:, :kk]
    return torch.gather(cat_d, 1, sel), torch.gather(cat_i, 1, sel)


def _order_keys(d: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is (distance, column): the f32 bits made
    order-preserving as int32 (negative values' magnitude bits flipped) in
    the high word, the column in the low word. One ``topk`` of the keys is
    then the stable sort's first columns, without a full-row sort."""
    bits = d.contiguous().view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    col = torch.arange(d.shape[1], device=d.device, dtype=torch.int64)
    return (bits << 32) | col[None, :]


def _smallest(d: torch.Tensor, t: int) -> torch.Tensor:
    """Columns of each row's ``t`` smallest entries in (value, column)
    order, in query-row chunks of at most 2^25 keys."""
    rows = max(1, (1 << 25) // max(d.shape[1], 1))
    out = [torch.topk(_order_keys(d[s:s + rows]), t, dim=1, largest=False).values & 0xFFFFFFFF
           for s in range(0, d.shape[0], rows)]
    return torch.cat(out)


def distributed_knn(mesh: Mesh, Xs: ShardedArray, n_items: int, k: int,
                    normalise: bool = False) -> tuple[ShardedArray, ShardedArray]:
    """Exact rectified-cosine kNN (``1 − max(cos, 0)``, full-f32 products)
    over the sharded rows, by D ring steps; at step s slot i scores the
    tile of slot i − s. Returns ``(dists [N_pad, kk], ids [N_pad, kk])``
    sharded like the rows, ``kk = min(k, n_items − 1)``; self excluded;
    padded query rows ``inf`` / −1; ties to the lower id."""
    per = Xs.per
    kk = min(k, n_items - 1)
    t = min(kk, per)
    if normalise:
        Xs = _standardize_global(mesh, Xs, n_items)
    xhat = local_map(mesh, lambda _, Xl: dist_ops.normalize_rows(Xl), Xs)
    slots = list(mesh.local_slots)
    tiles = list(xhat)
    best = [(torch.full((per, kk), float("inf"), device=x.device),
             torch.full((per, kk), -1, dtype=torch.int64, device=x.device)) for x in xhat]
    for step in range(mesh.size):
        for j, slot in enumerate(slots):
            dev = xhat[j].device
            with on_slot(dev):
                my_ids = slot * per + torch.arange(per, device=dev)
                tile_ids = ((slot - step) % mesh.size) * per + torch.arange(per, device=dev)
                d = 1.0 - torch.clamp(mm(xhat[j], tiles[j].T), min=0.0)
                invalid = (tile_ids[None, :] == my_ids[:, None]) | (tile_ids[None, :] >= n_items)
                d = torch.where(invalid, float("inf"), d)
                loc = _smallest(d, t)
                best[j] = _merge_knn(*best[j], torch.gather(d, 1, loc), tile_ids[loc], kk)
        if step + 1 < mesh.size:
            tiles = ring_shift(mesh, tiles)
    d_out, i_out = [], []
    for j, slot in enumerate(slots):
        bd, bi = best[j]
        pad_row = (slot * per + torch.arange(per, device=bd.device)) >= n_items
        d_out.append(torch.where(pad_row[:, None], float("inf"), bd))
        i_out.append(torch.where(pad_row[:, None], -1, bi))
    return (sharded(mesh, d_out, (Xs.shape[0], kk)), sharded(mesh, i_out, (Xs.shape[0], kk)))


@dataclasses.dataclass
class ShardedEllLaplacian:
    """Row-sharded exact ELL Laplacian ``L = diag(diag) − W``:
    ``indices/weights [N_pad, ell_k]`` (−1 / 0 padding), ``diag [N_pad]``;
    padded rows carry ``diag = PAD_DIAG`` and no edges.
    ``edge_list_bytes`` is the all-gathered edge list's transient (per
    process) of the assembly that made it."""

    indices: ShardedArray
    weights: ShardedArray
    diag: ShardedArray
    n_items: int
    dropped_reverse_edges: int
    edge_list_bytes: int = 0

    @property
    def shape(self):
        n = int(self.indices.shape[0])
        return (n, n)

    def to_dense(self) -> np.ndarray:
        """Host-side dense assembly (tests, small n)."""
        idx = self.indices.gather().cpu().numpy()
        w = self.weights.gather().cpu().numpy()
        n = idx.shape[0]
        W = np.zeros((n, n), np.float64)
        for i in range(n):
            for m in range(idx.shape[1]):
                j = idx[i, m]
                if j >= 0:
                    W[i, j] = max(W[i, j], w[i, m])
        L = np.diag(self.diag.gather().cpu().numpy().astype(np.float64)) - W
        return L[: self.n_items, : self.n_items]


def distributed_knn_ell_laplacian(mesh: Mesh, Xs: ShardedArray, n_items: int,
                                  params: GraphParams,
                                  reverse_k: int | str | None = None) -> ShardedEllLaplacian:
    """The item-graph Laplacian over the mesh with the single-card
    semantics: ring kNN → eps filter → kernel weights → degree
    sparsification (on the global mean degree, an f32 ``psum``) → union
    symmetrisation → ``L = D − W`` rows in ELL form.

    ``reverse_k`` caps the reverse-edge slots a row (default ``topk``);
    ``"auto"`` guarantees ``dropped_reverse_edges == 0``: one assembly at
    the default, and only if edges dropped a second at the measured max
    in-degree (the kNN reused). The symmetrisation all-gathers the
    directed edge list: an O(N·k) transient per process
    (``edge_list_bytes``)."""
    kk = min(int(params.topk), n_items - 1)
    nd, ids = distributed_knn(mesh, Xs, n_items, kk, normalise=bool(params.normalise))
    consts = (float(params.eps), float(params.p), float(params.sigma_value()))
    if reverse_k == "auto":
        out = _assemble_ell(mesh, nd, ids, n_items, kk, kk, *consts)
        if out.dropped_reverse_edges == 0 or kk >= n_items - 1:
            return out
        max_indeg = _max_indegree_device(mesh, ids, n_items)
        rk = min(max(max_indeg, kk + 1), n_items - 1)
        est_gb = ids.shape[0] * (kk + rk) * 8 / 1e9
        log.log(logging.WARNING if est_gb > 0.5 else logging.INFO,
                "distributed ELL auto reverse capacity grew to %d slots/row (first attempt "
                "%d dropped %d reverse edges) — ELL ids+weights ≈ %.2f GB across the mesh; "
                "pin reverse_k to bound memory instead",
                rk, kk, out.dropped_reverse_edges, est_gb)
        return _assemble_ell(mesh, nd, ids, n_items, kk, rk, *consts)
    rk = kk if reverse_k is None else int(reverse_k)
    return _assemble_ell(mesh, nd, ids, n_items, kk, rk, *consts)


def _max_indegree_device(mesh: Mesh, ids: ShardedArray, n_items: int) -> int:
    """Max in-degree over the real rows: each slot counts its real rows'
    ids into ``[n_items + 1]`` bins (the last for padding and empty
    slots), one ``psum``, one scalar to the host."""
    per = ids.per

    def body(slot, idl):
        real = ((slot * per + torch.arange(per, device=idl.device)) < n_items)[:, None]
        flat = torch.where(real & (idl >= 0), idl, n_items).reshape(-1)
        return torch.bincount(flat, minlength=n_items + 1)

    return int(torch.max(psum(mesh, local_map(mesh, body, ids))[:n_items]))


def _assemble_ell(mesh: Mesh, nd: ShardedArray, ids: ShardedArray, n_items: int, kk: int,
                  rk: int, eps: float, p: float, sigma: float) -> ShardedEllLaplacian:
    """ELL assembly at reverse capacity ``rk`` (the kNN is reused across
    the "auto" raise)."""
    per = ids.per
    n_pad = ids.shape[0]

    def weights(slot, ndl, idl):
        valid = (idl >= 0) & (ndl <= eps)
        w = 1.0 / (1.0 + (torch.where(valid, ndl, 0.0) / sigma) ** p)
        vmask = valid & (w > WEIGHT_FLOOR)
        degrees = torch.sum(valid, dim=1)
        real = (slot * per + torch.arange(per, device=idl.device)) < n_items
        # The degree total in f32, as the single-card recipe (an integer
        # sum would wrap at N·degree > 2^31).
        return torch.where(vmask, w, 0.0), vmask, degrees, torch.sum(
            torch.where(real, degrees, 0).to(torch.float32))

    st = local_map(mesh, weights, nd, ids)
    avg_degree = psum(mesh, [s[3] for s in st]) / n_items
    sparsify = bool(avg_degree > SPARSIFY_AVG_DEGREE)
    deg_all = all_gather(mesh, [s[2].to(torch.float32) for s in st], tiled=True)   # [N_pad]
    deg_r = replicate(mesh, deg_all)

    def sparsified(slot, idl, deg_g):
        w, vmask, degrees = st[slot - mesh.local_slots[0]][:3]
        if sparsify:
            score = w * torch.sqrt(degrees.to(torch.float32)[:, None]
                                   * deg_g[torch.clamp(idl, min=0)])
            score = torch.where(vmask, score, -float("inf"))
            order = torch.argsort(-score, dim=1, stable=True)
            ranks = torch.argsort(order, dim=1, stable=True)
            n_valid = torch.sum(vmask, dim=1)
            keep = torch.where(n_valid > 2, torch.clamp(n_valid // 2, min=1), n_valid)
            w = torch.where(ranks < keep[:, None], w, 0.0)
        return torch.where(w > 0, idl, -1), w

    fw = local_map(mesh, sparsified, ids, deg_r)
    ids_all = all_gather(mesh, [f[0] for f in fw], tiled=True)        # [N_pad, kk]
    w_all = all_gather(mesh, [f[1] for f in fw], tiled=True)
    # The directed edge list sorted by (dst, −weight), once a process (every
    # slot would sort the same list): each row's in-edges are then one
    # contiguous, weight-descending run.
    src = torch.arange(n_pad, device=ids_all.device).repeat_interleave(ids_all.shape[1])
    dst = ids_all.reshape(-1)
    ew = w_all.reshape(-1)
    dst_key = torch.where(dst >= 0, dst, n_pad)
    o = torch.argsort(-ew, stable=True)
    o = o[torch.argsort(dst_key[o], stable=True)]
    dst_s, src_s, ew_s = dst_key[o].contiguous(), src[o], ew[o]
    edge_bytes = sum(t.numel() * t.element_size()
                     for t in (ids_all, w_all, src, dst_key, o, dst_s, src_s, ew_s))
    ids_r, w_r = replicate(mesh, ids_all), replicate(mesh, w_all)
    edges_r = [replicate(mesh, t) for t in (dst_s, src_s, ew_s)]

    def assemble(slot, ia, wa, ds, ss, es):
        fwd_ids, w = [t.to(ia.device) for t in fw[slot - mesh.local_slots[0]]]
        my_ids = slot * per + torch.arange(per, device=ia.device)
        # Forward slots take max(w_ij, w_ji): does j point back at i?
        nb = torch.clamp(fwd_ids, min=0)
        nb_rows, nb_w = ia[nb], wa[nb]                                   # [per, kk, kk]
        rev_hit = (nb_rows == my_ids[:, None, None]) & (nb_w > 0)
        w_rev_fwd = torch.amax(torch.where(rev_hit, nb_w, 0.0), dim=2)
        w_fwd = torch.where(fwd_ids >= 0, torch.maximum(w, w_rev_fwd), 0.0)
        n_mutual = torch.sum(torch.any(rev_hit, dim=2) & (w_fwd > 0), dim=1)
        # Reverse-only edges: over-gather the run by the forward width (at
        # most kk of it are forward duplicates), drop duplicates, keep the
        # first rk.
        rkx = rk + kk
        lo = torch.searchsorted(ds, my_ids, right=False)
        hi = torch.searchsorted(ds, my_ids, right=True)
        take = lo[:, None] + torch.arange(rkx, device=ia.device)[None, :]
        in_run = take < hi[:, None]
        take = torch.clamp(take, max=ds.shape[0] - 1)
        cand_src = torch.where(in_run, ss[take], -1)
        cand_w = torch.where(in_run, es[take], 0.0)
        fwd_live = torch.where(w_fwd > 0, fwd_ids, -2)
        dup = torch.any(cand_src[:, :, None] == fwd_live[:, None, :], dim=2)
        ok = in_run & ~dup & (cand_w > 0)
        rank = torch.cumsum(ok.to(torch.int64), dim=1) - 1
        keep = ok & (rank < rk)
        slot_of = torch.where(keep, rank, rk)
        rev_src = torch.full((per, rk + 1), -1, dtype=torch.int64, device=ia.device).scatter_reduce_(
            1, slot_of, torch.where(keep, cand_src, -1), "amax")[:, :rk]
        rev_w = torch.zeros((per, rk + 1), device=ia.device).scatter_reduce_(
            1, slot_of, torch.where(keep, cand_w, 0.0), "amax")[:, :rk]
        dropped = torch.sum(torch.clamp((hi - lo) - n_mutual - rk, min=0))
        ell_ids = torch.cat([torch.where(w_fwd > 0, fwd_ids, -1), rev_src], dim=1)
        ell_w = torch.cat([w_fwd, rev_w], dim=1)
        diag = torch.where(my_ids < n_items, torch.sum(ell_w, dim=1), PAD_DIAG)
        return ell_ids.to(torch.int32), ell_w, diag, dropped

    out = local_map(mesh, assemble, ids_r, w_r, *edges_r)
    dropped = int(psum(mesh, [o[3] for o in out]))
    ek = kk + rk
    return ShardedEllLaplacian(
        indices=sharded(mesh, [o[0] for o in out], (n_pad, ek)),
        weights=sharded(mesh, [o[1] for o in out], (n_pad, ek)),
        diag=sharded(mesh, [o[2] for o in out], (n_pad,)),
        n_items=n_items, dropped_reverse_edges=dropped, edge_list_bytes=edge_bytes,
    )


def _checked_rows(ell: ShardedEllLaplacian) -> None:
    """Every live slot of every slot's rows names a row in ``[0, N_pad)``
    (kernel F's operand contract), once per graph."""
    n_pad = ell.indices.shape[0]
    for (_, idx), (_, w) in zip(ell.indices.local(), ell.weights.local()):
        fk.check_ell(idx, w, n_pad)


def distributed_lobpcg(mesh: Mesh, ell: ShardedEllLaplacian, k: int, iters: int = 100,
                       seed: int = 0, return_residuals: bool = False):
    """Smallest-k eigenpairs of the sharded ELL Laplacian: the single-card
    LOBPCG (:func:`..ops.eigensolver._lobpcg_core`) on the replicated
    ``[N_pad, k]`` block, whose operator applies each slot's rows through
    kernel F (``spmv_ell`` with ``row0``: ``d∘V − W@V`` for the slot's rows against
    the whole block; its plain version on the CPU) and gathers them. The
    start block is ``np.random.default_rng(seed).normal`` (the reference's
    draw, bit for bit). ``return_residuals=True`` adds ``‖L·x − θ·x‖₂`` per
    eigenpair."""
    if ell.dropped_reverse_edges:
        log.warning(
            "distributed_lobpcg: operator has %d dropped reverse edges (asymmetric rows); "
            "raise reverse_k in distributed_knn_ell_laplacian for exact eigenpairs",
            ell.dropped_reverse_edges)
    _checked_rows(ell)
    n_pad = int(ell.indices.shape[0])
    per = ell.indices.per
    X0 = torch.from_numpy(np.random.default_rng(seed).normal(size=(n_pad, k)).astype(np.float32))

    def matvec(V):
        Vr = replicate(mesh, V.contiguous())

        def rows(slot, idx, w, d, Vl):
            return fk.spmv_ell(idx, w, Vl, d, slot * per, checked=True)

        return all_gather(mesh, local_map(mesh, rows, ell.indices, ell.weights, ell.diag, Vr),
                          tiled=True)

    theta, Xk = _lobpcg_core(matvec, X0.to(mesh.lead), k, iters)
    vals, vecs = theta.cpu().numpy(), Xk.cpu().numpy()[: ell.n_items]
    if return_residuals:
        R = matvec(Xk) - Xk * theta[None, :]
        return vals, vecs, torch.sqrt(torch.sum(R * R, dim=0)).cpu().numpy()
    return vals, vecs
