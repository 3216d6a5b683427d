"""Plain replay of the build's radius-gated clustering scan, over every row.

Each row in turn (no sampling): the first row opens a centroid; after it,
the squared distance to the nearest centroid (the first of equal ones)
decides. Beyond ``0.5·radius`` while fewer than ``max_clusters`` exist the
row opens a new centroid; within ``radius`` it joins the nearest and moves
it to the running mean (``c += (x − c)/count``); within ``1.5·radius`` it is
counted without moving it; else it is dropped (-1).

The scan is sequential, but only a row that opens or moves a centroid
changes what later rows see. So the rows are taken in windows: the
distances of a window's rows to the centroids as they stand, in one
product, decide every row up to the first that changes the state; that
row is decided alone, and the next window starts after it. A window grows
while it holds no such row.

A decision within rounding of two outcomes (a distance within 1e-9 of its
scale of a threshold, or of a second centroid as near) is ambiguous: both
outcomes are right. With ``follow`` (the program's assignments) the replay
takes the program's outcome there when it is one of them, so that the
replay goes on from the same state; such rows are counted."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CREATE, RELAX = 0.5, 1.5
TOL = 1e-9
FIRST_WINDOW, MAX_WINDOW = 16, 1 << 16


@dataclasses.dataclass
class Clustering:
    centroids: torch.Tensor          # [C, F] in the replay's precision
    assignments: np.ndarray          # [N] int64, -1 for dropped rows
    counts: np.ndarray               # [C] int64
    ambiguous: int                   # rows decided within rounding of two outcomes


def _outcome(d: np.ndarray, ncent: int, cap: int, radius: float, tol: float, follow: int | None):
    """``(kind, index, ambiguous)`` for one row's distances ``d [ncent]``:
    kind one of "create", "move", "soft", "drop"."""
    b = int(np.argmin(d))
    bd = float(d[b])
    can_create = ncent < cap
    if can_create and bd > CREATE * radius:
        default = ("create", ncent)
    elif bd <= radius:
        default = ("move", b)
    elif bd <= RELAX * radius:
        default = ("soft", b)
    else:
        default = ("drop", -1)
    options = []
    if can_create and bd + tol > CREATE * radius:
        options.append(("create", ncent))
    if not (can_create and bd - tol > CREATE * radius):
        for j in np.flatnonzero(d <= bd + tol):
            dj = float(d[j])
            if dj - tol <= radius:
                options.append(("move", int(j)))
            if dj + tol > radius and dj - tol <= RELAX * radius:
                options.append(("soft", int(j)))
        if bd + tol > RELAX * radius:
            options.append(("drop", -1))
    ambiguous = len(options) > 1
    if ambiguous and follow is not None and follow != default[1]:
        for o in options:
            if o[1] == follow:
                return o[0], o[1], True
    return default[0], default[1], ambiguous


def replay(X: torch.Tensor, max_clusters: int, radius: float, prec,
           follow: np.ndarray | None = None) -> Clustering:
    """The scan over the rows of ``X [N, F]`` (float32, on its device) in
    ``prec`` (``reference.eigen.Precision``): distances in the expanded
    form ``|x|² + |c|² − 2⟨x, c⟩`` floored at 0, as the build computes them."""
    dev, dt = X.device, prec.dtype
    n, f = X.shape
    cap = int(max_clusters)
    C = torch.zeros((cap, f), dtype=dt, device=dev)
    cn = torch.zeros(cap, dtype=dt, device=dev)
    cnt = torch.zeros(cap, dtype=torch.int64, device=dev)
    out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    cr, rr = CREATE * radius, RELAX * radius
    ncent = pos = ambiguous = 0
    w = FIRST_WINDOW
    while pos < n:
        if ncent == 0:
            x = X[pos].to(dt)
            C[0], cn[0], cnt[0], out[pos] = x, (x * x).sum(), 1, 0
            ncent, pos = 1, pos + 1
            continue
        R = X[pos:pos + w]
        m = R.shape[0]
        Rd = prec.operand(R).to(dt)
        xsq = (Rd * Rd).sum(dim=1)
        D = torch.clamp(xsq[:, None] + cn[None, :ncent]
                        - 2.0 * prec.matmul(R, C[:ncent].T).to(dt), min=0.0)
        best = D.argmin(dim=1)
        bd = D.gather(1, best[:, None])[:, 0]
        tol = TOL * (xsq + cn[best] + 1.0)
        if ncent > 1:
            D2 = D.scatter(1, best[:, None], float("inf"))
            tie = (D2.min(dim=1).values - bd <= tol) & (bd - tol <= rr)
        else:
            tie = torch.zeros_like(bd, dtype=torch.bool)
        event = (bd <= radius + tol) | ((bd - rr).abs() <= tol) | tie
        if ncent < cap:
            event |= bd + tol > cr
        hit = torch.nonzero(event)
        e = int(hit[0, 0]) if hit.numel() else m
        if e:
            soft = torch.nonzero(bd[:e] <= rr)[:, 0]
            cnt.index_add_(0, best[soft], torch.ones_like(soft))
            out[pos + soft] = best[soft]
        if e == m:
            pos += m
            w = min(2 * w, MAX_WINDOW)
            continue
        i = pos + e
        d = D[e].double().cpu().numpy()
        kind, j, amb = _outcome(d, ncent, cap, radius, float(tol[e]),
                                None if follow is None else int(follow[i]))
        ambiguous += int(amb)
        x = X[i].to(dt)
        if kind == "create":
            C[ncent], cn[ncent], cnt[ncent] = x, (x * x).sum(), 1
            ncent += 1
        elif kind == "move":
            cnt[j] += 1
            C[j] += (x - C[j]) * (1.0 / cnt[j].to(dt))
            cn[j] = (C[j] * C[j]).sum()
        elif kind == "soft":
            cnt[j] += 1
        out[i] = j
        pos = i + 1
        w = max(FIRST_WINDOW, 2 * (e + 1))
    return Clustering(C[:ncent].clone(), out.cpu().numpy(), cnt[:ncent].cpu().numpy(), ambiguous)


def readings(rep: Clustering, assignments, centroids: torch.Tensor | None = None) -> dict:
    """``assign_mismatch``: rows the program assigned otherwise than the
    replay (a different centroid count is every row); with the program's
    ``centroids [C, F]``, ``centroid_err``: their largest distance from the
    replay's in any coordinate, over the replay's largest coordinate."""
    a = np.asarray(assignments, np.int64)
    out = {"assign_mismatch": int(np.sum(a != rep.assignments)) if a.shape == rep.assignments.shape
           else int(len(rep.assignments))}
    if centroids is not None:
        ref = rep.centroids.double()
        if tuple(centroids.shape) != tuple(ref.shape):
            out["centroid_err"] = float("inf")
        else:
            scale = max(float(ref.abs().max()), 1e-30)
            out["centroid_err"] = float((centroids.to(ref.device).double() - ref).abs().max()) / scale
    return out
