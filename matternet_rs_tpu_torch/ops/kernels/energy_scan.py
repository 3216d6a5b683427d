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
"""

from __future__ import annotations

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


def route(device, k: int) -> str:
    """Which way a full scan of ``k`` goes: ``"kernel"`` on a CUDA device
    for ``1 ≤ k ≤ 16``, ``"plain"`` otherwise."""
    return "kernel" if torch.device(device).type == "cuda" and 1 <= k <= K_MAX else "plain"


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
