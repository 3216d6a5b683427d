"""The comparison that decides ``correct``: what the timed path returned,
judged against the plain reference on the same inputs.

Every distinct answer of the window is judged (an answer repeated for a
pool query that came back again is judged once and counted as often as it
came). Readings of the answers, each a worst case over the judged ones:

``score_err``   largest |returned score − the reference's score of that id|
``rank_gap``    largest amount by which the reference's r-th best score
                exceeds the reference's score of the id returned at rank r
``order_gap``   largest amount by which a returned id scores above the
                one returned before it, by the reference's scores
``bad_ids``     answers with an id out of range, repeated or absent
``recall_shortfall``  1 − the share of the reference's top-k that the
                answers hold (an id at or above the k-th score counts),
                over every query answered; ``recall`` is its complement,
                the metric ``recall_at_10``

The index modes (``modes/<mode>.py``) add the readings of the build: λ,
the clustering replay's assignments and centroids, the energy build's
sub-centroids and the cosine tie-break (``tie_dist_err``,
``tie_rank_gap``). A traffic file's ``limits`` say which readings decide
``correct``."""

from __future__ import annotations

import numpy as np
import torch


def distinct_answers(answers, k: int):
    """``(qids [D], ids [D, k], scores [D, k] float64, counts [D])`` of the
    distinct (query, ids, scores) triples in ``answers``."""
    q = np.concatenate([a[0] for a in answers]).astype(np.int64)
    ids = np.concatenate([np.asarray(a[1], np.int64).reshape(-1, k) for a in answers])
    sc = np.concatenate([np.asarray(a[2], np.float64).reshape(-1, k) for a in answers])
    key = np.concatenate([q[:, None], ids, sc.view(np.int64)], axis=1)
    # A window repeats each pool query's answer thousands of times, and a
    # sort of whole rows is slow: group the rows by a 64-bit hash, then
    # confirm that every row equals its group's first. Two different rows
    # under one hash fall back to the sort of whole rows.
    mult = np.random.default_rng(0).integers(1, 2**62, key.shape[1], dtype=np.uint64) | 1
    h = (key.view(np.uint64) * mult).sum(axis=1)
    _, first, inv, counts = np.unique(h, return_index=True, return_inverse=True,
                                      return_counts=True)
    uniq = key[first]
    if not all(np.array_equal(key[i:i + 65536], uniq[inv[i:i + 65536]])
               for i in range(0, len(key), 65536)):
        uniq, counts = np.unique(key, axis=0, return_counts=True)
    return (uniq[:, 0], uniq[:, 1:1 + k], np.ascontiguousarray(uniq[:, 1 + k:]).view(np.float64),
            counts)


def _bad_rows(ids: np.ndarray, n: int) -> np.ndarray:
    s = np.sort(ids, axis=1)
    dup = np.any(s[:, 1:] == s[:, :-1], axis=1)
    return dup | np.any((ids < 0) | (ids >= n), axis=1)


def judge_answers(score_block, n_items: int, answers, k: int, block: int = 256,
                  higher_is_better: bool = True, score_below: float | None = None,
                  skip_at: float | None = None) -> dict:
    """Readings of ``answers`` against ``score_block(q0, q1) -> [q1 − q0, N]``
    float64 reference scores of pool queries ``q0 ≤ q < q1`` (distances,
    smaller first, with ``higher_is_better=False``). With ``score_below``,
    ``score_err`` reads only ids whose reference score lies below it; ids
    whose reference score is ``skip_at`` are judged by none of the three."""
    if not answers:
        return {"score_err": 0.0, "rank_gap": 0.0, "order_gap": 0.0, "bad_ids": 0, "recall": 0.0,
                "recall_shortfall": 1.0}
    qids, ids, sc, counts = distinct_answers(answers, k)
    sign = 1.0 if higher_is_better else -1.0
    bad = _bad_rows(ids, n_items)
    out = {"score_err": 0.0, "rank_gap": 0.0, "order_gap": 0.0,
           "bad_ids": int(counts[bad].sum())}
    hits = total = 0
    safe = np.clip(ids, 0, n_items - 1)
    for q0 in range(0, int(qids.max()) + 1, block):
        sel = np.nonzero((qids >= q0) & (qids < q0 + block))[0]
        if sel.size == 0:
            continue
        S = sign * score_block(q0, min(q0 + block, int(qids.max()) + 1))
        top = torch.topk(S, k, dim=1).values                    # [b, k] best first
        rows = torch.from_numpy(qids[sel] - q0).to(S.device)
        s_ref = torch.gather(S[rows], 1, torch.from_numpy(safe[sel]).to(S.device))
        got = torch.from_numpy(sign * sc[sel]).to(S.device)
        ok = torch.from_numpy(~bad[sel]).to(S.device)
        t = top[rows]
        okf = ok[:, None].expand_as(got)
        rated = okf if skip_at is None else okf & (s_ref != sign * skip_at)
        judged = rated if score_below is None else rated & (s_ref.abs() < score_below)
        out["score_err"] = max(out["score_err"], float(torch.where(
            judged, (got - s_ref).abs(), torch.zeros_like(got)).max()))
        out["rank_gap"] = max(out["rank_gap"], float(torch.where(
            rated, t - s_ref, torch.zeros_like(got)).max()))
        out["order_gap"] = max(out["order_gap"], float(torch.where(
            rated[:, 1:] & rated[:, :-1], s_ref[:, 1:] - s_ref[:, :-1],
            torch.zeros_like(got[:, 1:])).max()))
        c = torch.from_numpy(counts[sel]).to(S.device)
        h = ((s_ref >= t[:, k - 1:k]) & okf).sum(dim=1)
        hits += int((h * c).sum())
        total += int(c.sum()) * k
    out["recall"] = hits / total if total else 0.0
    out["recall_shortfall"] = 1.0 - out["recall"]
    return out


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` over the limited readings."""
    checks = {name: {"value": readings[name], "limit": lim} for name, lim in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
