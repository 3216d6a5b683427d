"""Plain reference of the energymaps index and its λ-distance scan.

From the clustering replay's centroids (``reference.clustering``) it works
the build out again: the optical compression (only where the token budget
covers every centroid, which then pass unpooled: the reference holds no
pooling), the bootstrap graph over the centroids' feature profiles, the
heat diffusion ``x ← x − η·x·Lᵀ``, the split of the rows at or above the
dispersion quantile into a (+, −) pair along their direction from the mean
of their nearest rows, then the energy graph over the sub-centroids, their
λ and its normalisation, each item's and each query's λ (that of its
nearest sub-centroid by L2), and the distances
``|λ − λq| + [|λ − λq| < 1e-9]·(1 − cos)·1e-9``, in float64.

Where two sub-centroids lie within rounding of equally near a row, either
is a right answer: an item takes the one whose λ the build gave it, when
that is one of them; a query takes the one that the distance of its first
returned id bears out."""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from portbench.reference.eigen import Precision, feature_laplacian, followed_laplacian, \
    graph_edges, kth_ties, normalisation, raw_lambdas

TIE_EPS = 1e-9
NEAR_REL = 1e-6          # nearest-centroid ties: within this share of |x|² + |c|²
OUT_OF_GROUP = 1e9
MERGED = 1e6
MAX_GRAPH_TIES = 3       # bootstrap-graph choices tried in every combination
TOL = 1e-5               # relative: 25 times the float32 error of the build's
                         # dispersion and squared distances (≈ 4e-7, measured)             # a λ group within λ's rounding of the query's own


def token_budget(n_items: int) -> int:
    """The adaptive token count of the build: 2√N within [100, 2000]."""
    return int(min(max(math.floor(2.0 * math.sqrt(n_items) + 0.5), 100), 2000))


def dispersion(rows: torch.Tensor, edges) -> torch.Tensor:
    """Per row, ``Σ(a·Δ²)² / (Σ a·Δ²)²`` over the graph's undirected edges
    (Δ the row's difference across the edge), 0 where the energy is nought."""
    ei, ej, a = edges
    diff = rows[:, ei] - rows[:, ej]
    e = a[None, :] * diff * diff
    total = e.sum(dim=1)
    num4 = (e * e).sum(dim=1)
    g = torch.where(total > 2e-12, 2.0 * num4 / torch.clamp(total * total, min=1e-24),
                    torch.zeros_like(total))
    return torch.clamp(g, 0.0, 1.0)


def _pairs(work: torch.Tensor, split: torch.Tensor, k: int, tau_share: float, prec: Precision):
    """The (+, −) pairs of the rows ``split`` of ``work``, interleaved, as
    ``(default, alternative, ambiguous, gap)``: the alternative takes each
    row's (k+1)-th nearest row in place of its k-th; ``ambiguous`` marks the
    rows where those two lie within rounding (``TOL``) of one another."""
    x, f = work.shape
    c = work[split]
    wn = (work * work).sum(dim=1)
    d2 = (c * c).sum(dim=1)[:, None] + wn[None, :] - 2.0 * prec.matmul(c, work.T).to(prec.dtype)
    d2 = torch.clamp(d2, min=0.0)
    d2[torch.arange(len(split), device=d2.device), split] = -1.0     # self first
    order = torch.sort(d2, dim=1, stable=True)
    nbrs = order.indices[:, 1:k + 1]
    alt = nbrs.clone()
    gap = torch.full((len(split),), float("inf"), dtype=d2.dtype, device=d2.device)
    if x > k + 1:
        kth, nxt = order.values[:, k], order.values[:, k + 1]
        gap = (nxt - kth) / torch.clamp(nxt, min=1e-30)
        alt[:, -1] = order.indices[:, k + 1]

    def pairs(nb):
        d = c - work[nb].mean(dim=1)
        nrm = torch.clamp(torch.sqrt((d * d).sum(dim=1)), min=1e-9)
        std_loc = torch.sqrt(((d - d.mean(dim=1, keepdim=True)) ** 2).mean(dim=1))
        step = (tau_share * torch.clamp(std_loc, min=1e-6) / nrm)[:, None] * d
        return torch.stack([c + step, c - step], dim=1).reshape(-1, f)

    return pairs(nbrs), pairs(alt), gap <= TOL, gap


def _nearer(a: torch.Tensor, b: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per pair of rows, ``a``'s or ``b``'s, whichever lies nearer ``target``."""
    da = (a - target).abs().reshape(-1, 2, a.shape[1]).amax(dim=(1, 2))
    db = (b - target).abs().reshape(-1, 2, a.shape[1]).amax(dim=(1, 2))
    return torch.where((db < da).repeat_interleave(2)[:, None], b, a)


def _distance(a: torch.Tensor, b: torch.Tensor | None) -> float:
    if b is None or tuple(a.shape) != tuple(b.shape):
        return float("inf")
    return float((a - b.to(a.device, a.dtype)).abs().max())


def _diffuse_and_split(C: torch.Tensor, L0: torch.Tensor, energy: dict, prec: Precision,
                       follow: torch.Tensor | None, margins: dict) -> torch.Tensor:
    x, f = C.shape
    work = C
    for _ in range(int(energy["steps"])):
        work = work - float(energy["eta"]) * prec.matmul(work, L0.T).to(prec.dtype)
    g = dispersion(work, graph_edges(L0))
    ranked = torch.sort(g, descending=True, stable=True)
    q_idx = int(math.floor((x - 1) * float(energy["split_quantile"]) + 0.5))
    n_split = x - q_idx
    splits = [torch.sort(ranked.indices[:n_split]).values]
    if n_split < x:
        last, nxt = ranked.values[n_split - 1], ranked.values[n_split]
        gap = float((last - nxt) / torch.clamp(last.abs(), min=1e-30))
        margins["split_gap"] = min(margins["split_gap"], gap)
        if gap <= TOL:
            margins["split_ties"] = 1
            swapped = torch.cat([ranked.indices[:n_split - 1], ranked.indices[n_split:n_split + 1]])
            splits.append(torch.sort(swapped).values)
    k = min(int(energy["neighbor_k"]), x - 1)
    best = None
    for split in splits:
        if not split.numel() or k < 1:
            S = work
        else:
            p0, p1, amb, gap = _pairs(work, split, k, float(energy["split_tau"]), prec)
            margins["neighbour_gap"] = min(margins["neighbour_gap"], float(gap.min()))
            margins["neighbour_ties"] = max(margins["neighbour_ties"], int(amb.sum()))
            if follow is not None and tuple(follow.shape) == (x + len(p0), f) and bool(amb.any()):
                chosen = _nearer(p0, p1, follow[x:].to(p0.device, p0.dtype))
                p0 = torch.where(amb.repeat_interleave(2)[:, None], chosen, p0)
            S = torch.cat([work, p0])
        if best is None or _distance(S, follow) < _distance(best, follow):
            best = S
    return best


def sub_centroids(centroids: torch.Tensor, graph: dict, energy: dict, n_items: int,
                  prec: Precision, follow: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """``(sub-centroids [S, F], margins)`` from the clustering's centroids.
    Three choices can lie within rounding: a feature's last neighbour in the
    bootstrap graph, which row is the last to split (the dispersion's ranks
    at the quantile), and a split row's k-th nearest row. Where they do,
    either is right: with ``follow`` (the program's sub-centroids) the
    reference takes the one nearer the program's. ``margins``: the smallest
    relative gaps at each choice, and how many were within rounding."""
    C = centroids.to(prec.dtype)
    x, f = C.shape
    if token_budget(n_items) < x:
        raise NotImplementedError("the reference holds no optical pooling: the token budget "
                                  f"{token_budget(n_items)} is below the {x} centroids")
    nodes = C.T.contiguous()
    topk = min(graph["topk"], x - 1)
    rows, _, _, gap0 = kth_ties(nodes, topk, prec)
    margins = {"bootstrap_gap": gap0, "bootstrap_ties": int(rows.numel()),
               "split_gap": float("inf"), "split_ties": 0,
               "neighbour_gap": float("inf"), "neighbour_ties": 0}
    choices = [rows[:0]]
    if follow is not None and 0 < rows.numel() <= MAX_GRAPH_TIES:
        choices = [rows[torch.tensor(m, dtype=torch.int64, device=rows.device)]
                   for r in range(1, rows.numel() + 1)
                   for m in itertools.combinations(range(rows.numel()), r)] + choices
    best = None
    for swap in choices:
        L0 = feature_laplacian(nodes, graph["eps"], graph["p"], graph["sigma"], topk, prec, swap)
        S = _diffuse_and_split(C, L0, energy, prec, follow, margins)
        if best is None or _distance(S, follow) < _distance(best, follow):
            best = S
    return best, margins


def _near_sets(rows: torch.Tensor, C: torch.Tensor, block: int = 1 << 15):
    """Per row: the nearest centroid and a ``[R, S]`` mask of those within
    rounding of as near (float64, expanded form)."""
    C = C.double()
    cn = (C * C).sum(dim=1)
    best, near = [], []
    for s in range(0, rows.shape[0], block):
        x = rows[s:s + block].double()
        xn = (x * x).sum(dim=1, keepdim=True)
        d2 = xn + cn[None, :] - 2.0 * x @ C.T
        m = d2.min(dim=1, keepdim=True).values
        near.append(d2 - m <= NEAR_REL * (xn + cn[None, :]))
        best.append(d2.argmin(dim=1))
    return torch.cat(best), torch.cat(near)


class EnergyIndex:
    """The reference index over ``X`` from its sub-centroids ``S [S, F]``."""

    def __init__(self, X: torch.Tensor, S: torch.Tensor, graph: dict, prec: str = "f64",
                 follow: torch.Tensor | None = None):
        self.prec = Precision(prec)
        self.X = X
        self.C = S.to(self.prec.dtype)
        L, self.graph_ties = followed_laplacian(self.C.T.contiguous(), graph, graph["topk"],
                                                self.prec, follow)
        raw = raw_lambdas(self.C, graph_edges(L), self.prec)
        mn, _, rng = normalisation(raw)
        self.sc_lams = ((raw - mn) / rng).double()
        self.best, self.near = _near_sets(X, self.C)
        self.lambdas = self.sc_lams[self.best].clone()
        Xd = self.prec.operand(X)
        self.norms = torch.sqrt((Xd * Xd).sum(dim=1))
        self.ambiguous_items = 0
        self.ambiguous_queries = 0
        self.q_lams = None

    def resolve_items(self, prog_lambdas: torch.Tensor) -> float:
        """Items whose nearest sub-centroid is a tie take the build's choice
        where it is one of the tied; returns the largest |λ − the
        reference's λ| over every item."""
        prog = prog_lambdas.to(self.sc_lams.device).double()
        self.lambdas = self.sc_lams[self.best].clone()
        amb = torch.nonzero(self.near.sum(dim=1) > 1, as_tuple=True)[0]
        if amb.numel():
            cand = torch.where(self.near[amb], self.sc_lams[None, :],
                               torch.full_like(self.near[amb], np.inf, dtype=torch.float64))
            pick = (cand - prog[amb, None]).abs().argmin(dim=1)
            self.lambdas[amb] = self.sc_lams[pick]
        self.ambiguous_items = int(amb.numel())
        return float((prog - self.lambdas).abs().max())

    def prepare_queries(self, Q: torch.Tensor, answers) -> None:
        """Each pool query's λ; a tied query takes the candidate under which
        the first id it was answered with lies at the returned distance."""
        best, near = _near_sets(Q, self.C)
        ql = self.sc_lams[best].clone()
        first = {}
        for q, ids, d in answers:
            for qi, i0, d0 in zip(np.asarray(q), np.asarray(ids)[:, 0], np.asarray(d)[:, 0]):
                first.setdefault(int(qi), (int(i0), float(d0)))
        amb = torch.nonzero(near.sum(dim=1) > 1, as_tuple=True)[0].tolist()
        for q in amb:
            if q in first and 0 <= first[q][0] < self.X.shape[0]:
                i0, d0 = first[q]
                cands = self.sc_lams[near[q]]
                ql[q] = cands[((self.lambdas[i0] - cands).abs() - d0).abs().argmin()]
        self.ambiguous_queries = len(amb)
        self.q_lams = ql

    def small_group_queries(self, k: int) -> int:
        """Pool queries whose own λ group holds fewer than ``k`` items (their
        answers reach into other groups, ordered by λ alone)."""
        s = torch.sort(self.lambdas).values
        n = (torch.searchsorted(s, self.q_lams, right=True)
             - torch.searchsorted(s, self.q_lams, right=False))
        return int((n < k).sum())

    def _parts(self, Q: torch.Tensor, q0: int):
        ql = self.q_lams[q0:q0 + Q.shape[0]]
        lam_d = (self.lambdas[None, :] - ql[:, None]).abs()
        Qd = self.prec.operand(Q)
        qn = torch.sqrt((Qd * Qd).sum(dim=1))
        cos = self.prec.matmul(Q, self.X.T).to(torch.float64) / (qn[:, None] * self.norms[None, :] + 1e-9)
        return lam_d, cos

    def distances(self, Q: torch.Tensor, q0: int) -> torch.Tensor:
        lam_d, cos = self._parts(Q, q0)
        return lam_d + torch.where(lam_d < TIE_EPS, (1.0 - cos) * TIE_EPS, torch.zeros_like(cos))

    def group_cosine_distances(self, Q: torch.Tensor, q0: int, lam_tol: float) -> torch.Tensor:
        """``1 − cos`` for the items of the query's own λ group: the order
        the tie-break alone decides. ``MERGED`` for items of another group
        whose λ lies within ``lam_tol`` of the query's (the program's float32
        λ may fall together with the query's there, or apart: either order
        is right), ``OUT_OF_GROUP`` elsewhere."""
        lam_d, cos = self._parts(Q, q0)
        return torch.where(lam_d == 0, 1.0 - cos, torch.where(
            lam_d <= lam_tol, torch.full_like(cos, MERGED), torch.full_like(cos, OUT_OF_GROUP)))

    def tie_band(self, Q: torch.Tensor, q0: int) -> tuple[float, float]:
        """``(pairs, distinct rows)`` of the batch's (query, item) pairs
        inside the tie band."""
        ql = self.q_lams[q0:q0 + Q.shape[0]]
        s = torch.sort(self.lambdas).values
        lo = torch.searchsorted(s, ql - TIE_EPS, right=True)
        hi = torch.searchsorted(s, ql + TIE_EPS, right=False)
        pairs = float((hi - lo).sum())
        uniq = torch.unique(torch.stack([lo, hi], dim=1), dim=0)
        covered = torch.zeros(s.shape[0] + 1, dtype=torch.int64, device=s.device)
        covered.index_add_(0, uniq[:, 0], torch.ones_like(uniq[:, 0]))
        covered.index_add_(0, uniq[:, 1], -torch.ones_like(uniq[:, 1]))
        rows = float((covered.cumsum(0)[:-1] > 0).sum())
        return pairs, rows
