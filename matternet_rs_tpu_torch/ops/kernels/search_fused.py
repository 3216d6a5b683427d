"""Kernel G: streamed exact blended top-k (``csrc/search_fused.cu``).

Replaces the TPU kernel ``search_fused.search_fused_pallas``. For
row-normalised ``Xn [N, F]`` and ``Qn [B, F]`` and normalised λ the score
is ``α·(Qn·Xnᵀ) + (1−α)·(1 − min(|λ − λq|, 1))`` (−3e38 for a row whose
λ exceeds 1.5, the reference's mark for a padded row), and each query keeps
its best ``k ≤ 16`` under the total order (score descending, id ascending).
The ``[B, N]`` scores are never written: the scan kernel leaves one sorted
list per query and N-range (:func:`scan_partials`), a second kernel merges
the lists (:func:`merge_partials`); :func:`search_fused` runs both. Because
the order is total the result does not depend on the number of ranges.

As in the reference, no search route calls this; it has its own entry
point. Each function has its plain PyTorch version beside it, taken only
for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops._mm import mm
from matternet_rs_tpu_torch.ops.kernels import _cuda

K_PAD = 16                    # widest list the kernel keeps (the reference's)
TILE_ROWS = 256               # corpus rows per tile of the scan kernel
_QUERY_BLOCK = 64             # queries per block of the scan kernel
_NEG = -3.0e38                # score of a masked row
_PAD_LAMBDA_CUT = 1.5         # λ above this marks a padded row (real λ ∈ [0, 1])
EMPTY_ID = 2**31 - 1          # id of an unfilled list entry (score −inf)


def k_keep(k: int, n: int) -> int:
    """List length for a request of ``k``: ``min(max(k, 1), 16, N)``;
    ``k > 16`` raises as the reference does."""
    if k > K_PAD:
        raise ValueError(
            f"search_fused keeps a fixed K_PAD={K_PAD}-wide running top-k; "
            f"k={k} exceeds it (use search_lambda_aware for larger k)"
        )
    return min(max(k, 1), K_PAD, n)


def _scores_plain(Xn, lambdas, Qn, q_lambdas, alpha: float):
    lam_sim = 1.0 - torch.clamp(torch.abs(lambdas[None, :] - q_lambdas[:, None]), max=1.0)
    scores = alpha * mm(Qn, Xn.T) + (1.0 - alpha) * lam_sim
    return torch.where(lambdas[None, :] > _PAD_LAMBDA_CUT,
                       torch.full_like(scores, _NEG), scores)


def _best_by_order(vals, ids, k: int):
    """Per row the ``k`` best of ``(vals, ids) [B, c]`` under (value
    descending, id ascending): two stable sorts, by id, then by value."""
    by_id = torch.argsort(ids, dim=1, stable=True)
    v, i = torch.gather(vals, 1, by_id), torch.gather(ids, 1, by_id)
    by_val = torch.argsort(v, dim=1, descending=True, stable=True)[:, :k]
    return torch.gather(v, 1, by_val), torch.gather(i, 1, by_val)


def _split_rows(n: int, splits: int) -> int:
    """Corpus rows per range: whole tiles, ``ceil(tiles / splits)`` each."""
    tiles = -(-n // TILE_ROWS)
    return -(-tiles // splits) * TILE_ROWS


def default_splits(n: int, b: int, device: torch.device) -> int:
    """Ranges of N per query block: about four blocks per multiprocessor
    over the whole grid, at most one range per tile."""
    tiles = -(-n // TILE_ROWS)
    qblocks = -(-b // _QUERY_BLOCK)
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if device.type == "cuda" else 1
    return max(1, min(tiles, (4 * sms) // qblocks))


def scan_partials_plain(Xn, lambdas, Qn, q_lambdas, k: int, alpha: float, splits: int):
    b, n = Qn.shape[0], Xn.shape[0]
    rows = _split_rows(n, splits)
    scores = _scores_plain(Xn, lambdas, Qn, q_lambdas, alpha)
    scores = torch.nn.functional.pad(scores, (0, splits * rows - n), value=-float("inf"))
    vals, pos = torch.sort(scores.view(b, splits, rows), dim=2, descending=True, stable=True)
    vals, pos = vals[:, :, :K_PAD], pos[:, :, :K_PAD]      # rows ≥ TILE_ROWS > K_PAD
    ids = pos + (torch.arange(splits, device=Xn.device) * rows)[None, :, None]
    ids = torch.where(torch.isinf(vals) & (vals < 0), torch.full_like(ids, EMPTY_ID), ids)
    return vals.contiguous(), ids.to(torch.int32).contiguous()


def scan_partials(Xn, lambdas, Qn, q_lambdas, k: int, alpha: float, splits: int):
    """Per query and N-range the sorted best-16 list: ``(vals, ids)
    [B, splits, 16]`` float32 / int32, unfilled entries ``(−inf,
    EMPTY_ID)``. The first ``k`` entries of a list are its range's best
    ``k``; the kernel keeps only those current, so what it leaves behind
    them are rows of the range that rank lower, not necessarily the next
    best. CPU tensors take the plain version; CUDA tensors launch the scan
    kernel."""
    n, f = Xn.shape
    b = Qn.shape[0]
    if Qn.shape != (b, f) or lambdas.shape != (n,) or q_lambdas.shape != (b,):
        raise ValueError("search_fused: inconsistent shapes")
    if not 1 <= k <= K_PAD or splits < 1 or n >= EMPTY_ID:
        raise ValueError(f"search_fused: k={k}, splits={splits}, N={n} out of range")
    if Xn.device.type == "cpu":
        return scan_partials_plain(Xn, lambdas, Qn, q_lambdas, k, alpha, splits)
    lib = _cuda.library("search_fused")
    tensors = dict(Xn=Xn, lambdas=lambdas, Qn=Qn, q_lambdas=q_lambdas)
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"search_fused kernel: {name} must be float32, got {t.dtype}")
    dev = _cuda.require_cuda("search_fused kernel", **tensors)
    vals = torch.empty((b, splits, K_PAD), dtype=torch.float32, device=dev)
    ids = torch.empty((b, splits, K_PAD), dtype=torch.int32, device=dev)
    if b == 0:
        return vals, ids
    rc = lib.mrs_search_fused_scan(
        Xn.data_ptr(), lambdas.data_ptr(), Qn.data_ptr(), q_lambdas.data_ptr(),
        float(alpha), 1.0 - float(alpha), n, f, b, k, splits,
        vals.data_ptr(), ids.data_ptr(), _cuda.stream_ptr(dev),
    )
    _cuda.check(lib, rc, "search_fused scan kernel")
    kernels.LAUNCHES["search_fused"] += 1
    return vals, ids


def merge_partials_plain(vals, ids, k: int):
    b = vals.shape[0]
    v, i = _best_by_order(vals.reshape(b, -1), ids.reshape(b, -1), k)
    return i, v


def order_keys(vals, ids) -> np.ndarray:
    """The merge kernel's 64-bit keys (numpy uint64) of float32 ``vals`` and
    int32 ``ids``: a larger key ranks first under (score descending, id
    ascending). The score's bits are mapped to an unsigned integer that
    grows with the score, −0.0 taken as +0.0 and every NaN above +inf; the
    id's, sign flipped and inverted, fill the low half. For tests."""
    v = np.ascontiguousarray(vals, dtype=np.float32)
    u = v.view(np.uint32).copy()
    u[u == 0x80000000] = 0
    u[np.isnan(v)] = 0x7FFFFFFF
    m = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)
    i = np.ascontiguousarray(ids, dtype=np.int32).view(np.uint32) ^ np.uint32(0x80000000)
    return (m << np.uint64(32)) | (~i).astype(np.uint64)


def _merge_operands(vals, ids, k: int) -> tuple:
    """The merge kernel's launch on CUDA tensors, checked, with its outputs
    allocated. Raises on what the kernel does not take."""
    lib = _cuda.library("search_fused")
    if vals.dtype != torch.float32 or ids.dtype != torch.int32:
        raise ValueError("search_fused merge kernel: vals float32 and ids int32 required")
    dev = _cuda.require_cuda("search_fused merge kernel", vals=vals, ids=ids)
    b, cand = vals.shape[0], vals.shape[1] * vals.shape[2]
    if k > cand:
        raise ValueError(f"search_fused merge kernel: k={k} exceeds the {cand} candidates")
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    return lib, vals, ids, k, out_v, out_i, dev


def _merge_launch(lib, vals, ids, k: int, out_v, out_i, dev):
    """Launch the merge on operands from :func:`_merge_operands`; counts it."""
    b, cand = vals.shape[0], vals.shape[1] * vals.shape[2]
    if b == 0:
        return out_i, out_v
    rc = lib.mrs_search_fused_merge(
        vals.data_ptr(), ids.data_ptr(), b, cand, k, out_v.data_ptr(), out_i.data_ptr(),
        _cuda.stream_ptr(dev),
    )
    _cuda.check(lib, rc, "search_fused merge kernel")
    kernels.LAUNCHES["search_fused_merge"] += 1
    return out_i, out_v


def merge_partials(vals, ids, k: int):
    """The best ``k`` of each query's candidate lists ``(vals, ids)
    [B, splits, w]`` (any order) under (score descending, id ascending;
    −0.0 and +0.0 equal) → ``(ids [B, k] int32, scores [B, k])``. CPU
    tensors take the plain version; CUDA tensors launch the merge kernel,
    which needs ``k ≤ splits·w``."""
    if vals.shape != ids.shape or vals.ndim != 3 or not 1 <= k <= K_PAD:
        raise ValueError(f"search_fused merge: vals {tuple(vals.shape)}, ids {tuple(ids.shape)}, k={k}")
    if vals.device.type == "cpu":
        return merge_partials_plain(vals, ids, k)
    return _merge_launch(*_merge_operands(vals, ids, k))


def empty_launch(device: torch.device) -> None:
    """Launch an empty kernel of the same library on ``device``'s current
    stream: timed like the merge, the cost of one launch."""
    lib = _cuda.library("search_fused")
    _cuda.check(lib, lib.mrs_search_fused_empty(_cuda.stream_ptr(device)), "empty kernel")


def search_fused_plain(Xn, lambdas, Qn, q_lambdas, k: int, alpha: float = 0.7):
    """All ``[B, N]`` scores at full f32, then a stable descending sort
    (lowest id first among equal scores)."""
    kk = k_keep(k, Xn.shape[0])
    scores = _scores_plain(Xn, lambdas, Qn, q_lambdas, float(alpha))
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return idx[:, :kk].to(torch.int32), vals[:, :kk]


def search_fused(Xn, lambdas, Qn, q_lambdas, k: int, alpha: float = 0.7,
                 splits: int | None = None):
    """Exact blended top-k for a query batch in one pass over ``Xn``, with
    no ``[B, N]`` score matrix.

    ``Xn [N, F]`` and ``Qn [B, F]`` must be row-normalised (the cosine is
    then a plain dot, taken at full f32); ``lambdas``/``q_lambdas`` are
    normalised λ ∈ [0, 1]. Returns ``(indices [B, k'] int32, scores
    [B, k'])`` with ``k' = min(max(k, 1), 16, N)``, sorted descending, ties
    toward the smaller index; ``k > 16`` raises ``ValueError``. The ids are
    int32 as the reference's are (``search_batch`` returns int64).
    ``splits`` is the number of N-ranges scanned independently (default:
    enough to fill the card); the result does not depend on it. CPU
    tensors take :func:`search_fused_plain`; CUDA tensors launch the two
    kernels."""
    n, b = Xn.shape[0], Qn.shape[0]
    kk = k_keep(k, n)
    if Xn.device.type == "cpu":
        return search_fused_plain(Xn, lambdas, Qn, q_lambdas, k, alpha)
    if splits is None:
        splits = default_splits(n, b, Xn.device)
    splits = max(1, min(int(splits), -(-n // TILE_ROWS)))
    vals, ids = scan_partials(Xn, lambdas, Qn, q_lambdas, kk, float(alpha), splits)
    return merge_partials(vals, ids, kk)
