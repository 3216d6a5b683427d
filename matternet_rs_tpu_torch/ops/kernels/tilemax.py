"""Kernels of the exact batched search (``csrc/tilemax.cu``).

* :func:`scores_and_tilemax` — kernel B, in place of the TPU kernel
  ``tilemax_fused.scores_and_tilemax``: blended scores for the first
  ``n0 = (N // tile) * tile`` corpus rows plus per-sub-tile maxima, in one
  corpus pass.
* :func:`gather_subtiles` — kernel C, in place of
  ``tilemax_fused.gather_subtiles``: each query's selected sub-tiles copied
  into one contiguous candidate row.
* :func:`select_topk` — the candidate stage in one launch
  (``subtile_topk``), in place of ``gather_subtiles`` and the selection
  around it: the sub-tiles with the largest maxima, their scores and the
  ragged tail ranked to the best ``kk ≤ 128`` (two designs: warp lists in
  registers up to 16, lists in shared memory beyond). Its plain version is
  the selection chain, :func:`select_topk_plain`, which larger ``kk`` take
  (with kernel C as their gather).

Each has its plain PyTorch version beside it, taken only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops import scores as score_ops
from matternet_rs_tpu_torch.ops._mm import mm
from matternet_rs_tpu_torch.ops.kernels import _cuda

# Sub-tile maxima per corpus tile (selection granularity), as on the TPU.
SUBS = 8
# Kernel B's limit: a block owns one sub-tile of exactly KERNEL_TS corpus
# rows, so it serves tile = SUBS * KERNEL_TS = 2048 (the default tile).
KERNEL_TS = 256
# The candidate stage's limits: kk up to TOPK_MAX_K in warp lists (one
# register lane an entry, as kernel G's merge), up to TOPK_MAX_K_WIDE in
# shared-memory lists; at most kk + 4 (the search's SELECT_MARGIN)
# sub-tiles; a tail shorter than a tile.
TOPK_MAX_K = 16
TOPK_MAX_K_WIDE = 128
_TOPK_MAX_C, _TOPK_MAX_C_WIDE, _TOPK_MAX_TAIL = 20, TOPK_MAX_K_WIDE + 4, 2048
# The wide design's block (one a query) and how many candidates a bar may
# let through before its radix select takes over.
WIDE_THREADS, WIDE_CAP = 512, 512
# Kernel B's block: 64 queries × 256 corpus rows, 32 features a chunk, a
# ring of 2 chunks in dynamic shared memory (``csrc/f32_tile_product.cuh``).
_BLOCK_QUERIES, _CHUNK_FEATURES, _RING = 64, 32, 2


def scores_tilemax_plan(b: int, f: int, aligned: bool = True) -> dict:
    """What the C entry point of kernel B chooses: ``loader`` ``"cp.async"``
    (16-byte copies) when ``f`` is a multiple of 4 floats and both the corpus
    and the query address are multiples of 16 bytes (``aligned``), else
    ``"elementwise"``; the ``smem_bytes`` it asks for (the same for any
    ``b`` and ``f``) and the ``blocks_per_tile``: query blocks that read each
    tile of 256 corpus rows (the first from device memory, the others from L2)."""
    return dict(
        loader="cp.async" if aligned and f % 4 == 0 else "elementwise",
        smem_bytes=_RING * (_BLOCK_QUERIES + KERNEL_TS) * _CHUNK_FEATURES * 4,
        blocks_per_tile=-(-b // _BLOCK_QUERIES),
    )


def scores_tilemax_plan_chosen(X, queries) -> dict:
    """:func:`scores_tilemax_plan` as the built library itself reports it for
    the corpus and query tensors (on the card)."""
    lib = _cuda.library("tilemax")
    vec, bm, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.mrs_scores_tilemax_plan(X.data_ptr(), queries.data_ptr(), X.shape[1],
                                     ctypes.byref(vec), ctypes.byref(bm), ctypes.byref(smem))
    _cuda.check(lib, rc, "scores_and_tilemax kernel plan")
    return dict(loader="cp.async" if vec.value else "elementwise", smem_bytes=smem.value,
                blocks_per_tile=-(-queries.shape[0] // bm.value))


def blend(dots, denom, lambdas, query_lambdas, alphas):
    """Kernel B's epilogue in plain PyTorch, on operands broadcast against
    ``dots``: :func:`..scores.blend` of :func:`..scores.guarded_cosine`."""
    return score_ops.blend(score_ops.guarded_cosine(dots, denom), lambdas, query_lambdas, alphas)


def blended_scores(dots, norms, lambdas, qn, query_lambdas, alphas):
    """:func:`blend` on ``dots [B, n]`` with per-row ``norms``/``lambdas``
    ``[n]`` and per-query ``qn``/``query_lambdas``/``alphas`` ``[B]``."""
    return blend(dots, norms[None, :] * qn[:, None], lambdas[None, :],
                 query_lambdas[:, None], alphas[:, None])


def scores_and_tilemax_plain(X, norms, lambdas, queries, query_lambdas, alphas,
                             tile: int = 2048, mask_from: int | None = None):
    n = X.shape[0]
    b = queries.shape[0]
    n0 = (n // tile) * tile
    ts = tile // SUBS
    qn = torch.sqrt(torch.sum(queries * queries, dim=-1))
    s = blended_scores(
        mm(queries, X[:n0].T), norms[:n0], lambdas[:n0], qn, query_lambdas, alphas
    )
    if mask_from is not None:
        col = torch.arange(n0, device=X.device)
        s = torch.where(col[None, :] >= mask_from, torch.full_like(s, -float("inf")), s)
    return s, s.view(b, n0 // ts, ts).amax(dim=2)


def scores_and_tilemax(X, norms, lambdas, queries, query_lambdas, alphas,
                       tile: int = 2048, mask_from: int | None = None):
    """Returns ``(scores [B, n0], submax [B, n0 // (tile // SUBS)])`` with
    ``n0 = (N // tile) * tile``; sub-tile ``j`` covers score columns
    ``[j·ts, (j+1)·ts)``, ``ts = tile // SUBS``. ``alphas`` is a ``[B]``
    vector. Columns ≥ ``mask_from`` score -inf. CPU tensors take the plain
    version; CUDA tensors launch kernel B."""
    if X.device.type == "cpu":
        return scores_and_tilemax_plain(
            X, norms, lambdas, queries, query_lambdas, alphas, tile, mask_from
        )
    lib = _cuda.library("tilemax")
    n, f = X.shape
    b = queries.shape[0]
    n0 = (n // tile) * tile
    if tile // SUBS != KERNEL_TS or tile % SUBS:
        raise ValueError(f"scores_and_tilemax kernel takes tile {SUBS * KERNEL_TS}, got {tile}")
    if queries.shape != (b, f) or norms.shape != (n,) or lambdas.shape != (n,) \
            or query_lambdas.shape != (b,) or alphas.shape != (b,):
        raise ValueError("scores_and_tilemax kernel: inconsistent shapes")
    tensors = dict(X=X, norms=norms, lambdas=lambdas, queries=queries,
                   query_lambdas=query_lambdas, alphas=alphas)
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"scores_and_tilemax kernel: {name} must be float32, got {t.dtype}")
    dev = _cuda.require_cuda("scores_and_tilemax kernel", **tensors)
    qn = torch.sqrt(torch.sum(queries * queries, dim=-1))
    scores = torch.empty((b, n0), dtype=torch.float32, device=dev)
    submax = torch.empty((b, n0 // KERNEL_TS), dtype=torch.float32, device=dev)
    if n0 == 0 or b == 0:
        return scores, submax
    rc = lib.mrs_scores_tilemax(
        X.data_ptr(), norms.data_ptr(), lambdas.data_ptr(), queries.data_ptr(),
        qn.data_ptr(), query_lambdas.data_ptr(), alphas.data_ptr(),
        n0 if mask_from is None else int(mask_from), n0, f, b,
        scores.data_ptr(), submax.data_ptr(), _cuda.stream_ptr(dev),
    )
    _cuda.check(lib, rc, "scores_and_tilemax kernel")
    kernels.count("scores_tilemax")
    return scores, submax


def gather_subtiles_plain(scores, sel, ts: int):
    b, n0 = scores.shape
    c = sel.shape[1]
    idx = sel.to(torch.int64)[:, :, None].expand(b, c, ts)
    return torch.gather(scores.view(b, n0 // ts, ts), 1, idx).reshape(b, c * ts)


def gather_subtiles(scores, sel, ts: int):
    """``cand[b, i·ts + a] = scores[b, sel[b, i]·ts + a]`` → ``[B, c·ts]``.
    CPU tensors take the plain version; CUDA tensors launch kernel C (any
    B; an out-of-range ``sel`` entry yields a NaN slice)."""
    if scores.device.type == "cpu":
        return gather_subtiles_plain(scores, sel, ts)
    lib = _cuda.library("tilemax")
    b, n0 = scores.shape
    c = sel.shape[1]
    if sel.shape[0] != b or n0 % ts:
        raise ValueError(f"gather_subtiles kernel: scores {tuple(scores.shape)}, sel {tuple(sel.shape)}, ts {ts}")
    if scores.dtype != torch.float32 or sel.dtype != torch.int64:
        raise ValueError("gather_subtiles kernel: scores float32 and sel int64 required")
    dev = _cuda.require_cuda("gather_subtiles kernel", scores=scores, sel=sel)
    out = torch.empty((b, c * ts), dtype=torch.float32, device=dev)
    if b == 0 or c == 0:
        return out
    rc = lib.mrs_gather_subtiles(
        scores.data_ptr(), sel.data_ptr(), out.data_ptr(), b, c, ts, n0,
        _cuda.stream_ptr(dev),
    )
    _cuda.check(lib, rc, "gather_subtiles kernel")
    kernels.count("gather_subtiles")
    return out


def select_topk_plain(main, tmax, tail, n: int, kk: int, margin: int, gather=None):
    """The selection chain. ``main [B, nt0, t]`` full-tile (or sub-tile)
    scores, ``tmax [B, nt0]`` their maxima, ``tail [B, n - nt0·t]`` the
    ragged remainder (always a candidate) or None. The ``c = min(nt0, kk +
    margin)`` tiles with the largest maxima (ties lowest id first) are
    sorted into id order so ties break by global index. ``gather(sel) ->
    [B, c·t]`` overrides the candidate gather (kernel C on the fused path).
    Returns ``(top [B, kk], idx [B, kk])``, ties lowest index first."""
    b, nt0, t = main.shape
    n0 = nt0 * t
    c = min(nt0, kk + margin)
    _, order = torch.sort(tmax, dim=-1, descending=True, stable=True)
    sel = torch.sort(order[:, :c], dim=1).values
    if gather is not None:
        cand = gather(sel)
    else:
        cand = torch.gather(main, 1, sel[:, :, None].expand(b, c, t)).reshape(b, c * t)
    if tail is not None:
        cand = torch.cat([cand, tail], dim=1)
    top, pos = torch.sort(cand, dim=-1, descending=True, stable=True)
    top, pos = top[:, :kk], pos[:, :kk]
    in_main = pos < c * t
    tile_of = torch.gather(sel, 1, torch.clamp(pos, max=c * t - 1) // t)
    gidx = torch.where(in_main, tile_of * t + pos % t, n0 + pos - c * t)
    return top, gidx


def select_route(device: torch.device, kk: int) -> str:
    """Which way :func:`select_topk` goes: ``"kernel"`` (the one-launch
    stage) for a tensor off the CPU and ``kk ≤ 128``, else ``"chain"``."""
    return "kernel" if device.type != "cpu" and kk <= TOPK_MAX_K_WIDE else "chain"


def subtile_topk_wide_plan() -> dict:
    """What the C entry point of the wide stage (16 < kk ≤ 128) chooses:
    ``threads`` a block (one block a query) and the ``cap`` of its lists,
    the one the wrapper passes."""
    return dict(threads=WIDE_THREADS, cap=WIDE_CAP)


def subtile_topk_wide_plan_chosen() -> dict:
    """:func:`subtile_topk_wide_plan` as the built library reports it."""
    lib = _cuda.library("tilemax")
    threads, cap = ctypes.c_int(), ctypes.c_int()
    rc = lib.mrs_subtile_topk_wide_plan(ctypes.byref(threads), ctypes.byref(cap))
    _cuda.check(lib, rc, "subtile_topk wide plan")
    return dict(threads=threads.value, cap=cap.value)


def _subtile_topk_operands(main, tmax, tail, n: int, kk: int, margin: int) -> tuple:
    """The candidate stage's launch on CUDA tensors, checked, with its
    outputs allocated: ``(wide, args, top, idx)``, ``wide`` for the entry of
    16 < kk ≤ 128. Raises on what the kernel does not take."""
    _cuda.library("tilemax")                       # raises without a card
    b, ns, ts = main.shape
    nr = 0 if tail is None else tail.shape[1]
    c = min(ns, kk + margin)
    wide = kk > TOPK_MAX_K
    if ts != KERNEL_TS or tmax.shape != (b, ns) or n != ns * ts + nr \
            or (tail is not None and tail.shape[0] != b):
        raise ValueError(f"subtile_topk kernel: main {tuple(main.shape)}, maxima "
                         f"{tuple(tmax.shape)}, tail {None if tail is None else tuple(tail.shape)}, n {n}")
    if c > (_TOPK_MAX_C_WIDE if wide else _TOPK_MAX_C) or nr > _TOPK_MAX_TAIL or n >= 2**31:
        raise ValueError(f"subtile_topk kernel: c={c}, tail {nr}, n {n} beyond its limits")
    tensors = dict(main=main, tmax=tmax) | ({} if tail is None else dict(tail=tail))
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"subtile_topk kernel: {name} must be float32, got {t.dtype}")
    dev = _cuda.require_cuda("subtile_topk kernel", **tensors)
    top = torch.empty((b, kk), dtype=torch.float32, device=dev)
    idx = torch.empty((b, kk), dtype=torch.int64, device=dev)
    args = (main.data_ptr(), tmax.data_ptr(), None if tail is None else tail.data_ptr(),
            b, ns, nr, c, kk)
    return wide, args, top, idx


def _subtile_topk_launch(wide, args, top, idx, cap: int = WIDE_CAP) -> None:
    """One launch of the stage on prepared operands (``cap``: the wide
    entry's; 0 sends its every selection through the radix select)."""
    lib = _cuda.library("tilemax")
    stream = _cuda.stream_ptr(top.device)
    if wide:
        rc = lib.mrs_subtile_topk_wide(*args, cap, top.data_ptr(), idx.data_ptr(), stream)
    else:
        rc = lib.mrs_subtile_topk(*args, top.data_ptr(), idx.data_ptr(), stream)
    _cuda.check(lib, rc, "subtile_topk kernel")


def select_topk(main, tmax, tail, n: int, kk: int, margin: int, gather=None):
    """:func:`select_topk_plain`'s result, values and ids bit for bit. CPU
    tensors and ``kk > 128`` take the chain (``gather`` its candidate
    gather); otherwise one launch of the candidate stage, which needs
    sub-tiles of ``KERNEL_TS`` rows, ``c = min(nt0, kk + margin)`` of at
    most 20 (``kk ≤ 16``) or 132, and a tail of at most 2,048 columns, and
    raises on anything else."""
    if select_route(main.device, kk) == "chain":
        return select_topk_plain(main, tmax, tail, n, kk, margin, gather)
    wide, args, top, idx = _subtile_topk_operands(main, tmax, tail, n, kk, margin)
    if main.shape[0] == 0 or kk == 0:
        return top, idx
    _subtile_topk_launch(wide, args, top, idx)
    kernels.count("subtile_topk")
    return top, idx
