"""Mesh-sharded λ and the distributed top-k searches (twin of the
reference's ``parallel/search.py``).

Every search scores its slot's rows, takes the slot's top-k, gathers the
k·D candidates and re-ranks them to the global top-k: exact, and
deterministic by the order (score desc, id asc). Padded rows are masked by
global id, never by norm (a real all-zero row is an item); per slot the
mask is the host integer ``mask_from = clamp(n_items − row0, 0,
n_local)``.

Each slot routes as the single-card search routes a corpus of its size
(the reference evaluates its predicates at the shard's ``n_local``, batch
and F), through the single-card routes themselves with the slot's
``mask_from`` (``core._routed_batched_search``, ``core._rescored_tier``,
``core._poolcut_scan``): the exact batch takes kernel B and the
candidate stage (kernel C's chain beyond k = 16) from
``FUSED_TILEMAX_MIN_N`` rows a slot, the quantised tiers kernels D and E
where :func:`..ops.search.fused_rescored_path` holds at the slot's size,
else the pool-cut scan.

``torch.argsort`` is not stable by default and ``lax.top_k`` / ``jnp``
sorts are: every sort here passes ``stable=True``, and a merge sorts by id
first, then stably by score (torch has no ``lexsort``).
"""

from __future__ import annotations

import torch

from matternet_rs_tpu_torch.core import _poolcut_scan, _rescored_tier, _routed_batched_search
from matternet_rs_tpu_torch.ops import scores as score_ops
from matternet_rs_tpu_torch.ops import search as so
from matternet_rs_tpu_torch.ops import taumode as tmo
from matternet_rs_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedArray,
    all_gather,
    local_map,
    replicate,
    sharded,
)

_NEG = -float("inf")


def merge_topk(all_s: torch.Tensor, all_i: torch.Tensor, width: int):
    """The deterministic re-rank along the last dim: ids ascending first,
    then a stable sort by score descending; the first ``width``. Returns
    ``(ids, scores)``."""
    o = torch.argsort(all_i, dim=-1, stable=True)
    s = torch.gather(all_s, -1, o)
    i = torch.gather(all_i, -1, o)
    sel = torch.argsort(-s, dim=-1, stable=True)[..., :width]
    return torch.gather(i, -1, sel), torch.gather(s, -1, sel)


def _gathered_rows(mesh: Mesh, parts: list[torch.Tensor]) -> torch.Tensor:
    """Per-slot ``[B, kk]`` candidates → ``[B, D·kk]`` in slot order."""
    st = all_gather(mesh, parts)                               # [D, B, kk]
    return st.permute(1, 0, 2).reshape(st.shape[1], -1)


def _valid(row0: int, n_local: int, n_items: int, device) -> torch.Tensor:
    return (row0 + torch.arange(n_local, device=device)) < n_items


def mask_from(n_items: int, row0: int, n_local: int) -> int:
    """First local row that is padding (``n_local`` when none is)."""
    return min(max(n_items - row0, 0), n_local)


def sharded_taumode_lambdas(mesh: Mesh, X_sharded: ShardedArray, L, tau_mode: int,
                            tau_param: float = 0.0, route_n: int | None = None) -> ShardedArray:
    """Raw λ of every row, per slot, with no communication (the graph is
    replicated). Each slot takes the single-card routed λ
    (:func:`..ops.taumode.taumode_lambdas_auto`) as a corpus of
    ``route_n`` rows would (default: the padded length): kernel A from
    ``KERNEL_MIN_N`` rows, so a mesh build equals the single-card build of
    the same rows. τ is per row, so the split does not change it."""
    n = X_sharded.shape[0] if route_n is None else int(route_n)

    def body(_, Xl, Ll):
        return tmo.taumode_lambdas_auto(Xl, Ll, tau_mode, tau_param, route_n=n)

    parts = local_map(mesh, body, X_sharded, replicate(mesh, L))
    return sharded(mesh, parts, (X_sharded.shape[0],))


def _query_candidates(mesh: Mesh, n_items: int, k: int, Xs, ns, ls, query, q_lambda, alpha):
    """Each slot's blended top-``kk`` for one query: ``(scores [D, kk],
    global ids [D, kk])`` in slot order."""
    per = Xs.per
    kk = min(k, per)
    q = replicate(mesh, torch.as_tensor(query, dtype=torch.float32))

    def body(slot, Xl, nl, ll, ql):
        row0 = slot * per
        s = so.lambda_aware_scores(Xl, nl, ll, ql, float(q_lambda), float(alpha))
        s = torch.where(_valid(row0, per, n_items, Xl.device), s, _NEG)
        top, idx = so.topk_stable(s, kk)
        return top, idx + row0

    outs = local_map(mesh, body, Xs, ns, ls, q)
    return all_gather(mesh, [o[0] for o in outs]), all_gather(mesh, [o[1] for o in outs])


def make_sharded_search(mesh: Mesh, n_items: int, k: int):
    """The distributed single-query search: ``search(X, norms, lambdas,
    query, q_lambda, alpha) -> (idx [w], scores [w])`` with global ids,
    ``w = min(k, D·kk)`` (``kk`` = min(k, rows a slot)), on the lead
    device."""

    def search(Xs, ns, ls, query, q_lambda, alpha):
        s, i = _query_candidates(mesh, n_items, k, Xs, ns, ls, query, q_lambda, alpha)
        return merge_topk(s.reshape(-1), i.reshape(-1), min(k, s.numel()))

    return search


def make_multislice_search(mesh: Mesh, n_items: int, k: int):
    """The single-query search over a ``("slice", "data")`` mesh, merged as
    the interconnect is layered: each slice's ``data`` slots first (keeping
    ``min(k, gathered)``), then the slices."""
    n_slices = mesh.shape["slice"]

    def search(Xs, ns, ls, query, q_lambda, alpha):
        s, i = _query_candidates(mesh, n_items, k, Xs, ns, ls, query, q_lambda, alpha)
        s1, i1 = s.reshape(n_slices, -1), i.reshape(n_slices, -1)
        i1, s1 = merge_topk(s1, i1, min(k, s1.shape[1]))       # stage 1: within a slice
        return merge_topk(s1.reshape(-1), i1.reshape(-1), min(k, s1.numel()))

    return search


def make_sharded_energy_search(mesh: Mesh, n_items: int, k: int):
    """The distributed energy search: ascending energy score
    (:func:`..ops.scores.energy_score`), per-slot top-k and one merge. Returns
    ``search(X, norms, lambdas, query, q_lambda) -> (idx, distances)``."""

    def search(Xs, ns, ls, query, q_lambda):
        per = Xs.per
        kk = min(k, per)
        q = replicate(mesh, torch.as_tensor(query, dtype=torch.float32))

        def body(slot, Xl, nl, ll, ql):
            row0 = slot * per
            qn = torch.sqrt(torch.sum(ql * ql))
            cos = score_ops.energy_cosine(so._scan_dots(Xl, ql), qn * nl)
            s = score_ops.energy_score(torch.abs(float(q_lambda) - ll), cos)
            s = torch.where(_valid(row0, per, n_items, Xl.device), s, float("inf"))
            neg, idx = so.topk_stable(-s, kk)
            return neg, idx + row0

        outs = local_map(mesh, body, Xs, ns, ls, q)
        all_s = all_gather(mesh, [o[0] for o in outs], tiled=True)
        all_i = all_gather(mesh, [o[1] for o in outs], tiled=True)
        i, neg = merge_topk(all_s, all_i, min(k, all_s.shape[0]))
        return i, -neg

    return search


def sharded_search_lambda_aware(mesh: Mesh, X_sharded, norms_sharded, lambdas_sharded, query,
                                q_lambda, k: int, alpha: float = 0.7,
                                n_items: int | None = None):
    """One distributed search; ``n_items`` is the real row count (default
    the padded length: pass it when the arrays carry padding)."""
    search = make_sharded_search(mesh, X_sharded.shape[0] if n_items is None else n_items, k)
    return search(X_sharded, norms_sharded, lambdas_sharded, query, q_lambda, alpha)


def make_sharded_search_batch(mesh: Mesh, n_items: int, k: int):
    """The batched exact search: per slot the single-card route at the
    slot's size (kernel B and the candidate stage with ``mask_from`` from
    ``FUSED_TILEMAX_MIN_N`` rows; else the ``[B, n_local]`` scores, masked,
    with the tile-max selection from ``TILEMAX_MIN_N``), one gather of
    ``B·kk`` candidates a slot and the per-row re-rank. Returns
    ``search(X, norms, lambdas, Q, q_lams, alpha) -> (idx [B, w], scores
    [B, w])``. Ids may differ from another route only on exact ties at a
    slot's kk-th score across a tile boundary (PARITY.md); scores do not."""

    def search(Xs, ns, ls, Q, QL, alpha):
        per = Xs.per
        kk = min(k, per)
        Qr, QLr = replicate(mesh, Q), replicate(mesh, QL)

        def body(slot, Xl, nl, ll, Ql, qll):
            row0 = slot * per
            idx, top = _routed_batched_search(Xl, nl, ll, Ql, qll, kk, alpha,
                                              mask_from=mask_from(n_items, row0, per))
            return top, idx + row0

        outs = local_map(mesh, body, Xs, ns, ls, Qr, QLr)
        all_s = _gathered_rows(mesh, [o[0] for o in outs])
        all_i = _gathered_rows(mesh, [o[1] for o in outs])
        return merge_topk(all_s, all_i, min(k, all_s.shape[1]))

    return search


QUANT_TIERS = ("int8", "int8_rescored", "bf16x3_rescored")


def make_sharded_search_batch_quantized(mesh: Mesh, n_items: int, k: int, cand: int,
                                        tier: str):
    """The batched search through a quantised tier, per slot: a
    reduced-precision scan, an exact rescore of the slot's candidates, and
    the merge of exact scores (so the merge is exact; sharding changes
    candidate recall only, upward: ``cand`` is per slot).

    ``"int8_rescored"``: the int8 sketch through kernels D and E
    (:func:`..ops.search.fused_scan_rescored` with the slot's
    ``mask_from``) where the maxima-first envelope holds at the slot's
    size, else the pool-cut scan; ``"int8"``: the pool-cut int8 scan;
    ``"bf16x3_rescored"``: the f32 rows at bf16x3 through D and E, else a
    full-f32 pool-cut scan. Returns ``search(X, [X8, mult,] norms, lambdas,
    Q, q_lams, alphas)``; the int8 tiers take the sketch pair."""
    if tier not in QUANT_TIERS:
        raise ValueError(
            f"sharded quantized tier must be 'int8', 'int8_rescored' or "
            f"'bf16x3_rescored', got {tier!r}"
        )
    int8_scan = tier in ("int8", "int8_rescored")

    def body_of(per: int):
        def body(slot, Xl, X8l, multl, nl, ll, Ql, qll, alphas):
            row0 = slot * per
            b = Ql.shape[0]
            kk = min(k, per)
            cc = max(min(cand, per), kk)
            a = score_ops.alpha_vector(alphas, b, Ql.device)
            mf = mask_from(n_items, row0, per)
            if tier == "int8":
                idx, top = _poolcut_scan(X8l, Xl, nl, ll, Ql, qll, kk, cc, a, multl, mf)
            else:
                idx, top = _rescored_tier(X8l if int8_scan else Xl, Xl, nl, ll, Ql, qll, kk, cc,
                                          a, scan_rn=multl if int8_scan else None, mask_from=mf)
            return top, idx + row0
        return body

    def run(Xs, X8s, mults, ns, ls, Q, QL, alphas):
        per = Xs.per
        kk = min(k, per)
        outs = local_map(mesh, body_of(per), Xs, X8s, mults, ns, ls, replicate(mesh, Q),
                         replicate(mesh, QL), replicate(mesh, torch.as_tensor(
                             alphas, dtype=torch.float32)))
        all_s = _gathered_rows(mesh, [o[0] for o in outs])
        all_i = _gathered_rows(mesh, [o[1] for o in outs])
        return merge_topk(all_s, all_i, min(k, mesh.size * kk))

    if int8_scan:
        return run

    def search(Xs, ns, ls, Q, QL, alphas):
        return run(Xs, None, None, ns, ls, Q, QL, alphas)

    return search


def make_sharded_hybrid_search(mesh: Mesh, n_items: int, k: int):
    """The distributed hybrid search (exact against the single-card one):
    the candidates are the global blended top-k, the rows with cosine above
    ``SEMANTIC_THRESHOLD`` and the global cosine argmax. Two collective
    stages: the slots' (best cosine, id) crown the argmax (ties to the
    lower id), then the slots' blended top-k give the global membership
    set; the final scores are row-local, so one more merge finishes.
    Returns ``search(X, norms, lambdas, query, q_lambda, alpha)``."""

    def search(Xs, ns, ls, query, q_lambda, alpha):
        per = Xs.per
        kk = min(k, per)
        q = replicate(mesh, torch.as_tensor(query, dtype=torch.float32))

        def scores(slot, Xl, nl, ll, ql):
            row0 = slot * per
            qn = torch.sqrt(torch.sum(ql * ql))
            cos = score_ops.guarded_cosine(so._scan_dots(Xl, ql), nl * qn)
            lam = score_ops.blend(cos, ll, float(q_lambda), float(alpha))
            gids = row0 + torch.arange(per, device=Xl.device)
            real = gids < n_items
            cos_m = torch.where(real, cos, _NEG)
            t = torch.argmax(cos_m)
            l_top, l_idx = so.topk_stable(torch.where(real, lam, _NEG), kk)
            return cos, lam, gids, real, cos_m[t], gids[t], l_top, gids[l_idx]

        st = local_map(mesh, scores, Xs, ns, ls, q)
        best = all_gather(mesh, [o[4] for o in st])
        best_id = all_gather(mesh, [o[5] for o in st])
        sem_top, _ = merge_topk(best, best_id, 1)
        g_s = all_gather(mesh, [o[6] for o in st], tiled=True)
        g_i = all_gather(mesh, [o[7] for o in st], tiled=True)
        gtop, _ = merge_topk(g_s, g_i, min(k, g_s.shape[0]))
        sem_r, gtop_r = replicate(mesh, sem_top), replicate(mesh, gtop)

        def final(slot, sem, top_ids):
            cos, lam, gids, real = st[slot - mesh.local_slots[0]][:4]
            in_topk = torch.isin(gids, top_ids)
            high = (cos > so.SEMANTIC_THRESHOLD) & real
            is_top = gids == sem[0]
            eligible = (in_topk | high | is_top) & real
            s = torch.where(high, cos, lam)
            s = torch.where(is_top & ~high & ~in_topk, cos, s)
            s = torch.where(eligible, s, _NEG)
            top, idx = so.topk_stable(s, kk)
            return top, gids[idx]

        outs = local_map(mesh, final, sem_r, gtop_r)
        all_s = all_gather(mesh, [o[0] for o in outs], tiled=True)
        all_i = all_gather(mesh, [o[1] for o in outs], tiled=True)
        return merge_topk(all_s, all_i, min(k, all_s.shape[0]))

    return search
