"""The energy full scan: kernel G's scan with the energy score in its
epilogue, then G's merge (``csrc/search_fused.cu``).

For raw rows ``X [N, F]`` with their norms and λ, and raw queries
``Q [B, F]`` with their λ, the energy score of a (query, row) pair is

    d = |qλ − λ|,   s = d + (1 − cos)·TIE_EPS where d < TIE_EPS, else s = d,
    cos = Q·X / (‖Q‖·‖X‖ + 1e-9),   TIE_EPS = 1e-9 (``ops/scores.py``),

and each query keeps its ``k`` least scores, lowest index first among
equal ones (the stable ascending top-k). :func:`energy_topk_plain` is the
plain version: the ``[B, N]`` scores (:func:`energy_scores_plain`), then
a stable sort. :func:`energy_topk` takes it only for CPU tensors; for CUDA
tensors it launches the scan, which keeps per query and N-range the best
16 of −s in registers (G's order, largest first and lowest id on ties, is
then the plain version's), and G's merge of those lists: no ``[B, N]``
plane and no sort. The kernel rounds every step of the score as the plain
version does; only the dot's summation order differs (ascending features,
one FMA each), so the two agree under ``utils/parity.same_k_mismatches``
at ``ENERGY_TIE_TOL``.

The window route (:func:`energy_topk_window`, ``csrc/energy_window.cu``)
gives ``energy_topk``'s answer bit for bit, ids and distances, with the
dots taken only inside each query's tie band. It reads the index's sorted
λ (``index/sorted.DeviceSortedLambdas``): since ``d = |qλ − λ|`` is
rounded monotonically, it falls then rises along the sorted λ, so a
query's band ``d < TIE_EPS`` is one run of sorted positions, found by
binary search on the card. The band's rows, read through the sorted ids,
are scored exactly as the scan scores them (the same FMA chain and
epilogue) by queries grouped by band: a band of at most
:func:`narrow_width` queries (8) on a narrow tile that streams its rows
once, a larger one 64 queries to a tile (:func:`window_plan_plain`
mirrors the cut); a row outside the band scores exactly ``d``, so each
query then walks out of its band on both sides, taking rows while one
could still rank before its k-th, and stops at the first row that cannot
(every row farther out has a larger ``d``).
The proof is in the kernel's header. :func:`energy_topk_window_plain` is
the same rule in plain PyTorch and Python. ``LAUNCHES["energy_window"]``
counts the route's launches (the plan, the wide and narrow band scans and
the walks, one C call per 1,024 queries); :func:`window_tally` reads a tally kept on the
card (band pairs, dot pairs taken, queries whose walk took a row, rows
walked, dot pairs taken by narrow tiles), which the search never reads.
"""

from __future__ import annotations

import bisect
import collections
import ctypes
import threading

import torch

from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops import scores as score_ops
from matternet_rs_tpu_torch.ops._mm import mm
from matternet_rs_tpu_torch.ops.kernels import _cuda
from matternet_rs_tpu_torch.ops.kernels import search_fused as sfk
from matternet_rs_tpu_torch.ops.search import topk_stable

TIE_EPS = score_ops.TIE_EPS
K_MAX = sfk.K_PAD             # the widest k the kernel keeps


def query_norms(Q: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(Q * Q, dim=-1))


def energy_scores_plain(X, norms, lambdas, Q, q_lams):
    """``[B, N]`` energy scores (:func:`..scores.energy_score`), dots at full f32."""
    cosine = score_ops.energy_cosine(mm(Q, X.T), query_norms(Q)[:, None] * norms[None, :])
    return score_ops.energy_score(torch.abs(q_lams[:, None] - lambdas[None, :]), cosine)


def energy_topk_plain(X, norms, lambdas, Q, q_lams, k: int):
    """All ``[B, N]`` scores, then a stable sort: ``(indices [B, k] int64,
    distances [B, k])``, ascending, ties lowest index first."""
    neg, idx = topk_stable(-energy_scores_plain(X, norms, lambdas, Q, q_lams), k)
    return idx, -neg


def route(device, k: int, window: bool = False) -> str:
    """Which way a full scan of ``k`` goes: on a CUDA device for
    ``1 ≤ k ≤ 16`` ``"window"`` where the caller has a current sorted-λ
    view on the card (``window``), else ``"kernel"``; ``"plain"``
    otherwise."""
    if torch.device(device).type != "cuda" or not 1 <= k <= K_MAX:
        return "plain"
    return "window" if window else "kernel"


def scan_partials(X, norms, lambdas, Q, qn, q_lams, k: int, splits: int):
    """Per query and N-range the best-16 list of −s: ``(vals, ids)
    [B, splits, 16]`` float32 / int32, unfilled entries ``(−inf,
    EMPTY_ID)``, as :func:`search_fused.scan_partials` leaves them. CUDA
    tensors only: launches the energy scan, or raises."""
    n, f = X.shape
    b = Q.shape[0]
    if (Q.shape != (b, f) or norms.shape != (n,) or lambdas.shape != (n,)
            or qn.shape != (b,) or q_lams.shape != (b,)):
        raise ValueError("energy scan: inconsistent shapes")
    sfk.check_scan_range("energy scan", n, k, splits)
    lib, dev, vals, ids = sfk.scan_operands("energy scan", b, splits, X=X, norms=norms,
                                            lambdas=lambdas, Q=Q, qn=qn, q_lams=q_lams)
    if b == 0:
        return vals, ids
    rc = lib.mrs_energy_scan(
        X.data_ptr(), norms.data_ptr(), lambdas.data_ptr(), Q.data_ptr(), qn.data_ptr(),
        q_lams.data_ptr(), n, f, b, k, splits, vals.data_ptr(), ids.data_ptr(),
        _cuda.stream_ptr(dev),
    )
    _cuda.check(lib, rc, "energy scan kernel")
    kernels.count("energy_scan")
    return vals, ids


def energy_topk(X, norms, lambdas, Q, q_lams, k: int):
    """The ``k`` least energy scores of each query, ties lowest index
    first: ``(indices [B, k] int64, distances [B, k] float32)``, as
    :func:`energy_topk_plain` returns them. CPU tensors take the plain
    version; CUDA tensors launch the scan, over enough N-ranges to fill
    the card, and the merge, with no read-back (``1 ≤ k ≤ min(16, N)``,
    else ``ValueError``)."""
    if X.device.type == "cpu":
        return energy_topk_plain(X, norms, lambdas, Q, q_lams, k)
    n, b = X.shape[0], Q.shape[0]
    if not 1 <= k <= min(K_MAX, n):
        raise ValueError(f"energy scan kernel: k={k} outside [1, min(16, N={n})]")
    splits = sfk.default_splits(n, b, X.device)
    vals, ids = scan_partials(X, norms, lambdas, Q, query_norms(Q), q_lams, k, splits)
    idx, neg = sfk.merge_partials(vals, ids, k)
    return idx.long(), -neg


# -- the window route (csrc/energy_window.cu) ---------------------------------

# The window route's tally, one per card, made at first use under a lock
# (serving launches from two dispatch threads), as kernels.LAUNCHES is one
# per process.
_TALLY: dict[torch.device, torch.Tensor] = {}
_TALLY_LOCK = threading.Lock()
TALLY_NAMES = ("band_pairs", "dot_pairs", "queries_past_band", "rows_walked", "narrow_dot_pairs")
WINDOW_QUERIES = 1024         # queries one C call of the window route takes
TILE_QUERIES, TILE_ROWS = 64, 256   # a wide tile's query slots and a tile's rows


def _tally(device: torch.device) -> torch.Tensor:
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _TALLY_LOCK:
        t = _TALLY.get(device)
        if t is None:
            t = _TALLY[device] = torch.zeros(len(TALLY_NAMES), dtype=torch.int64, device=device)
    return t


def window_tally(device) -> dict[str, int]:
    """The window route's tally on ``device`` since the last reset: band
    pairs scored, dot pairs the tiles took (query slots × rows of every
    tile, 64 or ``narrow_width`` slots), queries whose walk took a row
    outside the band, rows the walks read, dot pairs of the narrow tiles.
    Reading it waits for the card; the search never does."""
    return dict(zip(TALLY_NAMES, _tally(torch.device(device)).tolist()))


def reset_window_tally(device) -> None:
    _tally(torch.device(device)).zero_()


def _window_sizes(lib) -> tuple[int, int, int]:
    qmax, ws_len, narrow = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.mrs_energy_window_sizes(ctypes.byref(qmax), ctypes.byref(ws_len), ctypes.byref(narrow))
    return qmax.value, ws_len.value, narrow.value


def narrow_width() -> int:
    """The queries a narrow tile of the loaded window kernels holds (a band
    of at most that many takes one); 0 where they have no narrow tile."""
    return _window_sizes(_cuda.library("energy_window"))[2]


def window_plan_plain(s_lam, q_lams, narrow_w: int) -> dict[str, int]:
    """What the window kernels' plan adds to the tally, in plain Python:
    ``band_pairs``, ``dot_pairs`` and ``narrow_dot_pairs``, summed over the
    C calls of 1,024 queries that :func:`energy_topk_window` makes. In one
    call: each query's band (:func:`_band_edges`; none for a NaN λ or an
    empty band), the banded queries sorted by (band, index), then two cuts,
    the one with fewer 256-row tiles taken (the band cut on a tie): each
    band its own groups, one narrow group of ``narrow_w`` slots where it
    holds at most ``narrow_w`` queries, else groups of 64; or consecutive
    64s of the sorted queries over the union of their bands."""
    if len(q_lams) > WINDOW_QUERIES:
        calls = [window_plan_plain(s_lam, q_lams[c:c + WINDOW_QUERIES], narrow_w)
                 for c in range(0, len(q_lams), WINDOW_QUERIES)]
        return {name: sum(c[name] for c in calls) for name in calls[0]}
    nv = int(torch.sum(~torch.isnan(s_lam)))
    bands = sorted((*_band_edges(s_lam[:nv], q)[:2], i) for i, q in enumerate(q_lams.tolist())
                   if q == q)
    bands = [(lo, hi) for lo, hi, _ in bands if lo < hi]

    def tiles(lo, hi):
        return -(-(hi - lo) // TILE_ROWS)

    wide_b = narrow_b = 0
    for (lo, hi), n in collections.Counter(bands).items():
        if n <= narrow_w:
            narrow_b += tiles(lo, hi)
        else:
            wide_b += -(-n // TILE_QUERIES) * tiles(lo, hi)
    wide_u = sum(tiles(bands[c][0], max(hi for _, hi in bands[c:c + TILE_QUERIES]))
                 for c in range(0, len(bands), TILE_QUERIES))
    if wide_u < wide_b + narrow_b:
        wide_b, narrow_b = wide_u, 0
    narrow = narrow_b * narrow_w * TILE_ROWS
    return dict(band_pairs=sum(hi - lo for lo, hi in bands),
                dot_pairs=wide_b * TILE_QUERIES * TILE_ROWS + narrow, narrow_dot_pairs=narrow)


def energy_topk_window(X, norms, s_lam, s_idx, Q, q_lams, k: int):
    """:func:`energy_topk`'s answer through the tie bands: ``X [N, F]``,
    ``norms [N]``, the index's ascending λ ``s_lam [N]`` (float32, NaN
    last) and the item at each position ``s_idx [N]`` (int64), queries
    ``Q [B, F]`` and ``q_lams [B]``. Returns ``(indices [B, k] int64,
    distances [B, k] float32)``. CPU tensors take
    :func:`energy_topk_window_plain`; CUDA tensors launch the window
    kernels, 1,024 queries at a time, with no read-back (``1 ≤ k ≤
    min(16, N)``, else ``ValueError``)."""
    if X.device.type == "cpu":
        return energy_topk_window_plain(X, norms, s_lam, s_idx, Q, q_lams, k)
    n, f = X.shape
    b = Q.shape[0]
    if (Q.shape != (b, f) or norms.shape != (n,) or s_lam.shape != (n,) or s_idx.shape != (n,)
            or q_lams.shape != (b,)):
        raise ValueError("energy window: inconsistent shapes")
    if not 1 <= k <= min(K_MAX, n) or n >= sfk.EMPTY_ID:
        raise ValueError(f"energy window kernel: k={k} outside [1, min(16, N={n})]")
    lib = _cuda.library("energy_window")
    for name, t in dict(X=X, norms=norms, s_lam=s_lam, Q=Q, q_lams=q_lams).items():
        if t.dtype != torch.float32:
            raise ValueError(f"energy window kernel: {name} must be float32, got {t.dtype}")
    if s_idx.dtype != torch.int64:
        raise ValueError(f"energy window kernel: s_idx must be int64, got {s_idx.dtype}")
    dev = _cuda.require_cuda("energy window kernel", X=X, norms=norms, s_lam=s_lam, s_idx=s_idx,
                             Q=Q, q_lams=q_lams)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return ids.long(), -vals
    qmax, ws_len, _ = _window_sizes(lib)
    grid = sfk.blocks_per_wave(dev)
    qn = query_norms(Q)
    ws = torch.empty(ws_len, dtype=torch.int64, device=dev)
    pv = torch.empty((min(b, qmax), grid, k), dtype=torch.float32, device=dev)
    pi = torch.empty((min(b, qmax), grid, k), dtype=torch.int32, device=dev)
    tally = _tally(dev)
    for c0 in range(0, b, qmax):
        c1 = min(b, c0 + qmax)
        rc = lib.mrs_energy_window(
            X.data_ptr(), norms.data_ptr(), s_lam.data_ptr(), s_idx.data_ptr(),
            Q[c0:c1].data_ptr(), qn[c0:c1].data_ptr(), q_lams[c0:c1].data_ptr(), n, f, c1 - c0,
            k, grid, ws.data_ptr(), pv.data_ptr(), pi.data_ptr(), vals[c0:c1].data_ptr(),
            ids[c0:c1].data_ptr(), tally.data_ptr(), _cuda.stream_ptr(dev),
        )
        _cuda.check(lib, rc, "energy window kernel")
        kernels.count("energy_window")
    return ids.long(), -vals


def _band_edges(sl, ql):
    """``[lo, hi)``: the positions of the ascending λ ``sl`` whose
    ``|ql − λ|`` is below ``TIE_EPS``, by the kernel's two predicates; and
    every position's ``|ql − λ|``."""
    d = torch.abs(ql - sl)
    lo = int(torch.sum(~((sl >= ql) | (d < TIE_EPS))))
    hi = sl.shape[0] - int(torch.sum((sl > ql) & ~(d < TIE_EPS)))
    return lo, hi, d


def _band(sl, ql):
    """:func:`_band_edges` with the distances negated, as a list."""
    lo, hi, d = _band_edges(sl, ql)
    return lo, hi, (-d).tolist()


def energy_topk_window_plain(X, norms, s_lam, s_idx, Q, q_lams, k: int):
    """The window rule in plain PyTorch and Python, as the kernels apply
    it: per query the k first of its band's rows under (−s descending, id
    ascending), then the walks out of the band on both sides, a row at a
    time, each side stopping at the first row that ranks after the k-th.
    The scores are :func:`energy_scores_plain`'s, read only in the band;
    a row outside it is taken at ``−|Δλ|``. Rows with a NaN score are never
    taken; where fewer than k can be, the rest is ``(2^31 − 1, inf)``, as
    the kernel leaves it. Returns ``(indices [B, k] int64, distances
    [B, k] float32)``."""
    b = Q.shape[0]
    lam = torch.empty_like(s_lam)
    lam[s_idx] = s_lam
    neg = (-energy_scores_plain(X, norms, lam, Q, q_lams)).tolist()
    nv = int(torch.sum(~torch.isnan(s_lam)))
    sl, items = s_lam[:nv], s_idx[:nv].tolist()
    out_i = torch.full((b, k), sfk.EMPTY_ID, dtype=torch.int64)
    out_v = torch.full((b, k), -float("inf"), dtype=torch.float32)
    for q in range(b):
        if torch.isnan(q_lams[q]):
            continue
        lo, hi, negd = _band(sl, q_lams[q])
        best: list[tuple[float, int]] = []      # (−v, id) ascending: the list, best first

        def take(v: float, i: int) -> None:
            key = (-v, i)
            if v == v and (len(best) < k or key < best[-1]):
                bisect.insort(best, key)
                del best[k:]

        for p in range(lo, hi):
            take(neg[q][items[p]], items[p])
        left, right = lo - 1, hi
        while left >= 0 or right < nv:
            if left >= 0:
                take(negd[left], items[left])
                left = -1 if len(best) == k and negd[left] < -best[-1][0] else left - 1
            if right < nv:
                take(negd[right], items[right])
                right = nv if len(best) == k and negd[right] < -best[-1][0] else right + 1
        for e, (mv, i) in enumerate(best):
            out_v[q, e], out_i[q, e] = -mv, i
    return out_i.to(Q.device), (-out_v).to(Q.device)
