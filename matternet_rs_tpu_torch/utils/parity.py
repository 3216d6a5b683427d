"""The near-tie rule for comparing two top-k results.

Two exact searches over the same index may rank differently only where
scores tie within the f32 summation-order error of their dot products.
:func:`topk_mismatches` states that rule once, for the tests and for
``chip_smoke.py``; :func:`same_k_mismatches` is its form for two results
taken at the same k.
"""

from __future__ import annotations

import numpy as np


def topk_mismatches(ref_ids, ref_scores, got_ids, got_scores, tol: float = 1e-5) -> list[str]:
    """Rows where ``got`` (``[B, k]``) departs from ``ref`` beyond near ties.

    ``ref`` carries ``k + 1`` columns, so the score just past the cut is
    known. Per row: the scores agree position by position within ``tol``;
    a position may hold another id only if the two scores there agree
    within ``tol`` (a swap of near-tied items); and an id outside the
    reference's top-k may enter only when the reference's k-th and
    (k+1)-th scores differ by less than ``tol``. Returns one message per
    failing row (empty when they match)."""
    ref_ids, ref_scores = np.asarray(ref_ids), np.asarray(ref_scores, np.float64)
    got_ids, got_scores = np.asarray(got_ids), np.asarray(got_scores, np.float64)
    k = got_ids.shape[1]
    if ref_ids.shape[1] != k + 1:
        raise ValueError("the reference result needs k + 1 columns")
    bad = []
    for b in range(got_ids.shape[0]):
        gap = abs(ref_scores[b, k - 1] - ref_scores[b, k])
        d = np.abs(got_scores[b] - ref_scores[b, :k])
        if not np.all(d < tol):
            bad.append(f"row {b}: scores differ by {d.max():.3g}")
            continue
        outside = set(got_ids[b].tolist()) - set(ref_ids[b, :k].tolist())
        if outside and gap >= tol:
            bad.append(f"row {b}: ids {sorted(outside)} outside the reference top-{k}, gap {gap:.3g}")
    return bad


def same_k_mismatches(ref_ids, ref_scores, got_ids, got_scores, tol: float = 1e-5) -> list[str]:
    """Rows where two ``[B, k]`` results taken at the same k depart beyond
    near ties — the rule for the rescored tiers, whose candidate slabs
    depend on k, so a reference run at ``k + 1`` (:func:`topk_mismatches`)
    would select differently. Per row: the scores agree position by
    position within ``tol``, so a position may hold another id only where
    the two scores there agree within ``tol``. Returns one message per
    failing row (empty when they match)."""
    ref_ids, ref_scores = np.asarray(ref_ids), np.asarray(ref_scores, np.float64)
    got_ids, got_scores = np.asarray(got_ids), np.asarray(got_scores, np.float64)
    if ref_ids.shape != got_ids.shape:
        raise ValueError(f"shapes differ: {ref_ids.shape} vs {got_ids.shape}")
    bad = []
    for b in range(got_ids.shape[0]):
        far = ~(np.abs(got_scores[b] - ref_scores[b]) < tol)
        if far.any():
            j = int(np.argmax(far))
            bad.append(f"row {b} position {j}: id {got_ids[b, j]} score {got_scores[b, j]:.7g} "
                       f"vs id {ref_ids[b, j]} score {ref_scores[b, j]:.7g}")
    return bad
