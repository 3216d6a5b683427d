"""Plain reference of the eigenmaps index and its blended search.

From the centroids of the clustering replay (``reference.clustering``)
it works out the F×F feature graph, every item's λ and its normalisation,
each query's λ, and the blended scores ``α·cos + (1 − α)·(1 − min(|λ − λq|, 1))`` over the
whole corpus, in float64 on the device the inputs are on.

``precision="tf32"`` is the control: every operand of a product rounded to
TF32 (10 mantissa bits, as the tensor cores read float32 with TF32 on) and
the arithmetic in float32."""

from __future__ import annotations

import torch

TAU_FLOOR = 1e-10
ZERO_ROW = 1e-10
WEIGHT_FLOOR = 1e-12
SPARSIFY_AVG_DEGREE = 10.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away)."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


class Precision:
    def __init__(self, name: str):
        if name not in ("f64", "tf32"):
            raise ValueError(name)
        self.name = name
        self.dtype = torch.float64 if name == "f64" else torch.float32

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as a product reads it."""
        return x.to(self.dtype) if self.name == "f64" else round_tf32(x)

    def matmul(self, a, b):
        return self.operand(a) @ self.operand(b)


GRAPH_TOL = 1e-6        # rectified-cosine distance: 10 times the float32 product's error


def _feature_distances(nodes: torch.Tensor, prec: Precision) -> torch.Tensor:
    x = nodes.to(prec.dtype)
    xn = x / torch.clamp(torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)), min=1e-12)
    d = 1.0 - torch.clamp(prec.matmul(xn, xn.T).to(prec.dtype), min=0.0)
    d.fill_diagonal_(float("inf"))
    return d


def kth_ties(nodes: torch.Tensor, topk: int, prec: Precision):
    """``(rows, kth, next, smallest gap)``: the nodes whose k-th and
    (k+1)-th nearest lie within ``GRAPH_TOL`` of one another, so that
    rounding may pick either as the last neighbour."""
    d = _feature_distances(nodes, prec)
    kk = min(topk, d.shape[0] - 1)
    if kk >= d.shape[0] - 1:
        empty = torch.zeros(0, dtype=torch.int64, device=d.device)
        return empty, empty, empty, float("inf")
    s = torch.sort(d, dim=1, stable=True)
    gap = s.values[:, kk] - s.values[:, kk - 1]
    rows = torch.nonzero(gap <= GRAPH_TOL)[:, 0]
    return rows, s.indices[rows, kk - 1], s.indices[rows, kk], float(gap.min())


def feature_laplacian(nodes: torch.Tensor, eps: float, p: float, sigma: float, topk: int,
                      prec: Precision, swap_rows=None) -> torch.Tensor:
    """``L = D − W`` over the rows of ``nodes [n, m]``: rectified-cosine kNN
    (self excluded, ties to the lower index), weights ``1/(1 + (d/σ)^p)``
    for ``d ≤ eps``, the degree sparsification past a mean degree of 10,
    ``W = max(W, Wᵀ)``. The nodes in ``swap_rows`` take their (k+1)-th
    nearest in place of their k-th (a choice within rounding)."""
    d = _feature_distances(nodes, prec)
    n = d.shape[0]
    kk = min(topk, n - 1)
    ranked = torch.sort(d, dim=1, stable=True).indices
    order = ranked[:, :kk].clone()
    if swap_rows is not None and len(swap_rows):
        order[swap_rows, kk - 1] = ranked[swap_rows, kk]
    nd = torch.gather(d, 1, order)
    valid = nd <= eps
    w = 1.0 / (1.0 + (nd / sigma) ** p)
    vmask = valid & (w > WEIGHT_FLOOR)
    w = torch.where(vmask, w, torch.zeros_like(w))
    deg = valid.sum(dim=1).to(prec.dtype)
    if float(deg.mean()) > SPARSIFY_AVG_DEGREE:
        score = torch.where(vmask, w * torch.sqrt(deg[:, None] * deg[order]),
                            torch.full_like(w, -float("inf")))
        rank = torch.argsort(torch.argsort(-score, dim=1, stable=True), dim=1, stable=True)
        n_valid = vmask.sum(dim=1)
        keep = torch.where(n_valid > 2, torch.clamp(n_valid // 2, min=1), n_valid)
        w = torch.where(rank < keep[:, None], w, torch.zeros_like(w))
    W = torch.zeros((n, n), dtype=prec.dtype, device=d.device)
    W = W.scatter_reduce(1, order, w, reduce="amax", include_self=True)
    W = torch.maximum(W, W.T)
    return torch.diag(W.sum(dim=1)) - W


def followed_laplacian(nodes: torch.Tensor, graph: dict, topk: int, prec: Precision,
                       follow: torch.Tensor | None = None):
    """``(L, ties)``: the feature graph, where a node's last neighbour is a
    choice within rounding taking the program's (``follow``, its Laplacian):
    the (k+1)-th where the program holds that edge and not the k-th."""
    rows, kth, nxt, _ = kth_ties(nodes, topk, prec)
    swap = rows[:0]
    if follow is not None and rows.numel():
        A = follow.to(rows.device)
        take = (A[rows, nxt] != 0) & (A[rows, kth] == 0)
        swap = rows[take]
    return feature_laplacian(nodes, graph["eps"], graph["p"], graph["sigma"], topk, prec,
                             swap), int(rows.numel())


def graph_edges(L: torch.Tensor):
    """Ordered edges ``(i, j, a_ij)`` of ``A = max(−L, 0)`` off the diagonal."""
    A = torch.clamp(-L, min=0.0)
    A.fill_diagonal_(0.0)
    i, j = torch.nonzero(A, as_tuple=True)
    return i, j, A[i, j]


def median_tau(x: torch.Tensor) -> torch.Tensor:
    s = torch.sort(x, dim=1).values
    f = x.shape[1]
    med = s[:, f // 2] if f % 2 else 0.5 * (s[:, f // 2 - 1] + s[:, f // 2])
    return torch.clamp(med, min=TAU_FLOOR)


def raw_lambdas(X: torch.Tensor, edges, prec: Precision, block: int = 1 << 16) -> torch.Tensor:
    """Raw taumode λ ``[N]`` (τ the row's median), edge by edge:
    ``E = ½Σ a(x_i − x_j)² / Σx²`` (= xᵀLx/xᵀx), the dispersion
    ``G = Σ(a(x_i − x_j)²)² / (Σ a(x_i − x_j)²)²`` over ordered edges,
    ``λ = τ·E/(E + τ) + (1 − τ)·G``; rows with max|x| ≤ 1e-10 score 0."""
    ei, ej, a = edges
    a = prec.operand(a)
    out = []
    for s in range(0, X.shape[0], block):
        x = prec.operand(X[s:s + block])
        diff = x[:, ei] - x[:, ej]
        e = a[None, :] * diff * diff
        total = e.sum(dim=1)
        num4 = (e * e).sum(dim=1)
        den = (x * x).sum(dim=1)
        zero = torch.zeros_like(den)
        E = torch.clamp(torch.where(den > 1e-12, 0.5 * total / torch.clamp(den, min=1e-12), zero),
                        min=0.0)
        G = torch.clamp(torch.where(total > 1e-12, num4 / torch.clamp(total * total, min=1e-24),
                                    zero), 0.0, 1.0)
        tau = median_tau(x)
        eb = torch.where(E + tau > 0, E / torch.clamp(E + tau, min=TAU_FLOOR), zero)
        lam = tau * eb + (1.0 - tau) * G
        is_zero = torch.amax(torch.abs(x), dim=1) <= ZERO_ROW
        out.append(torch.where(is_zero, zero, lam))
    return torch.cat(out)


def normalisation(raw: torch.Tensor):
    """``(min, max, range)``: max folded from 0, range floored at 1e-9."""
    mn = float(raw.min())
    mx = max(float(raw.max()), 0.0)
    return mn, mx, max(mx - mn, 1e-9)


class EigenIndex:
    """The reference index over ``X`` from the centroids ``[C, F]``."""

    def __init__(self, X: torch.Tensor, centroids: torch.Tensor, graph: dict, prec: str = "f64",
                 follow: torch.Tensor | None = None):
        self.prec = Precision(prec)
        self.X = X
        self.L, self.graph_ties = followed_laplacian(centroids.T.contiguous(), graph,
                                                     graph["topk"], self.prec, follow)
        self.edges = graph_edges(self.L)
        raw = raw_lambdas(X, self.edges, self.prec)
        self.mn, self.mx, self.rng = normalisation(raw)
        self.lambdas = (raw - self.mn) / self.rng
        Xd = self.prec.operand(X)
        self.norms = torch.sqrt(torch.sum(Xd * Xd, dim=1))

    def query_lambdas(self, Q: torch.Tensor) -> torch.Tensor:
        raw = raw_lambdas(Q, self.edges, self.prec)
        return torch.clamp((raw - self.mn) / self.rng, 0.0, 1.0)

    def scores(self, Q: torch.Tensor, alpha: float) -> torch.Tensor:
        """``[B, N]`` blended scores of the queries ``Q`` against every row."""
        ql = self.query_lambdas(Q)
        Qd = self.prec.operand(Q)
        qn = torch.sqrt(torch.sum(Qd * Qd, dim=1))
        dots = self.prec.matmul(Q, self.X.T).to(self.prec.dtype)
        denom = qn[:, None] * self.norms[None, :]
        cos = torch.where(denom > 1e-12, dots / torch.clamp(denom, min=1e-12), torch.zeros_like(dots))
        lam_sim = 1.0 - torch.clamp(torch.abs(self.lambdas[None, :] - ql[:, None]), max=1.0)
        return alpha * cos + (1.0 - alpha) * lam_sim

