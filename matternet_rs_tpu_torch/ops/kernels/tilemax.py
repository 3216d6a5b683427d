"""Kernels B and C of the exact batched search (``csrc/tilemax.cu``).

* :func:`scores_and_tilemax` — kernel B, in place of the TPU kernel
  ``tilemax_fused.scores_and_tilemax``: blended scores for the first
  ``n0 = (N // tile) * tile`` corpus rows plus per-sub-tile maxima, in one
  corpus pass.
* :func:`gather_subtiles` — kernel C, in place of
  ``tilemax_fused.gather_subtiles``: each query's selected sub-tiles copied
  into one contiguous candidate row.

Each has its plain PyTorch version beside it, taken only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops._mm import mm
from matternet_rs_tpu_torch.ops.kernels import _cuda

# Sub-tile maxima per corpus tile (selection granularity), as on the TPU.
SUBS = 8
# Kernel B's limit: a block owns one sub-tile of exactly KERNEL_TS corpus
# rows, so it serves tile = SUBS * KERNEL_TS = 2048 (the default tile).
KERNEL_TS = 256
# Kernel B's block: 64 queries × 256 corpus rows, 32 features a chunk, a
# ring of 3 chunks in dynamic shared memory (``csrc/f32_tile_product.cuh``).
_BLOCK_QUERIES, _CHUNK_FEATURES, _RING = 64, 32, 3


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
    """THE scoring epilogue (the reference's ``_guarded_cosine`` and
    ``_blend``) on operands that already broadcast against ``dots``:
    ``α·cos + (1-α)·(1 - min(|λ - λq|, 1))`` with ``cos = dots/denom``, 0
    where ``denom ≤ 1e-12``."""
    cos = torch.where(
        denom > 1e-12, dots / torch.clamp(denom, min=1e-12), torch.zeros_like(dots)
    )
    lam_sim = 1.0 - torch.clamp(torch.abs(lambdas - query_lambdas), max=1.0)
    return alphas * cos + (1.0 - alphas) * lam_sim


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
    kernels.LAUNCHES["scores_tilemax"] += 1
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
    kernels.LAUNCHES["gather_subtiles"] += 1
    return out
