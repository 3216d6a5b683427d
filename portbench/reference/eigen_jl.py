"""Plain reference of the eigenmaps index built in a JL-projected λ space.

The build it judges: the clustering scan over the raw F-wide rows; the
scan's centroids projected by an ``[F, r]`` Gaussian matrix, with ``r`` by
the JL rule on the number of centroids; the r × r feature graph from the
projected centroids; every item's λ of its projected row; each query's λ
of its projected query; the blended score ``α·cos + (1 − α)·(1 −
min(|λ − λq|, 1))`` with the cosine over the raw rows. All in float64 on
the device the inputs are on, with TF32 off; ``precision="tf32"`` is the
control (``reference.eigen.Precision``).

Three pieces are its own:

* :func:`jl_dim` — the target width: ``r ≥ 8·ln(n)/ε²`` clamped to
  ``[32, F]`` (with a buffer of ×1.2–2.0 past 2048 features), then at most
  ``F // 2``; the projection is made only where ``r`` exceeds the number
  of centroids.
* :func:`jl_matrix` — the matrix as drawn from its seed, in float64:
  ``jax.random.normal(PRNGKey(seed), (F, r)) / √r`` from the published
  algorithm (threefry2x32, 20 rounds, over the flat index as a (high, low)
  counter pair, 32-bit draws ``bits1 ^ bits2``; the mantissa fill into
  ``[nextafter(−1, 0), 1)`` in float32; ``√2·erfinv(u)`` in float64).
  The program keeps only the seed and draws the same stream in float32;
  the judge reads the largest gap between the two.
* :func:`replay` — the clustering scan (``reference.clustering``'s rules)
  over the raw rows, in windows that also take rows that move a centroid:
  a window's distances to the centroids as they stand bound every later
  row's distance within the window, since a row that moves centroid ``j``
  shifts it by at most ``√radius / count``. A row whose outcome is the
  same at both ends of that bound (a move to its nearest, or a drop) is
  decided in the window; the first row that is not starts the next
  window, and a window's first row is decided alone, as the plain scan
  decides it. Moves of a window fold into each centroid's running mean
  ``(n·c + Σx) / (n + m)``, which the sequential updates
  ``c += (x − c)/count`` give exactly.

Nothing here imports the program, ``jax`` or the JAX package."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import clustering
from portbench.reference.eigen import (Precision, followed_laplacian, graph_edges, normalisation,
                                       raw_lambdas)

ROW_BLOCK = 1 << 13                 # rows projected and given their λ at a time


def tf32_off() -> None:
    """Float32 products at full precision on the card, cuBLAS and cuDNN:
    the control rounds its operands itself."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def jl_dim(n_points: int, original_dim: int, epsilon: float) -> int:
    """The JL width for ``n_points`` at distortion ``epsilon``."""
    if original_dim < 32:
        return original_dim
    bound = math.ceil(8.0 * math.log(max(n_points, 1)) / epsilon ** 2)
    if original_dim > 2048:
        ratio = original_dim / max(bound, 1)
        buffer = 1.2 if ratio < 10.0 else (1.5 if ratio < 100.0 else 2.0)
        return int(min(max(math.ceil(bound * buffer), 32), original_dim))
    return int(min(max(bound, 32), original_dim))


def projected_dim(n_centroids: int, original_dim: int, epsilon: float) -> int | None:
    """The width the build projects to, or None where it makes no
    projection (the target is not below F or not above the centroids)."""
    r = min(jl_dim(n_centroids, original_dim, epsilon), original_dim // 2)
    return r if n_centroids < r < original_dim else None


# threefry2x32 on int64 tensors holding unsigned 32-bit words.
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def jl_matrix(seed: int, original_dim: int, reduced_dim: int, device) -> torch.Tensor:
    """The ``[F, r]`` float64 matrix of ``seed``: the standard normal draw
    of ``PRNGKey(seed)`` (key words ``(0, seed mod 2³²)``) over ``(F, r)``,
    times ``1/√r``."""
    n = original_dim * reduced_dim
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = _threefry2x32(0, int(seed) & _M32, idx >> 32, idx & _M32)
    mant = ((b1 ^ b2) >> 9).to(torch.float32) * 2.0 ** -23      # exact: [0, 1)
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).to(device)
    u = torch.maximum(lo, mant * (1.0 - lo) + lo)                # float32, as drawn
    normal = math.sqrt(2.0) * torch.erfinv(u.double())
    return (normal / math.sqrt(reduced_dim)).reshape(original_dim, reduced_dim)


def replay(X: torch.Tensor, max_clusters: int, radius: float, prec: Precision,
           follow: np.ndarray | None = None) -> clustering.Clustering:
    """The scan over the rows of ``X [N, F]`` (float32, on its device) in
    ``prec``, distances in the expanded form floored at 0; ``follow`` (the
    program's assignments) settles a row decided within rounding of two
    outcomes, as ``reference.clustering.replay`` does."""
    tf32_off()
    dev, dt = X.device, prec.dtype
    n, f = X.shape
    cap = int(max_clusters)
    C = torch.zeros((cap, f), dtype=dt, device=dev)
    cn = torch.zeros(cap, dtype=dt, device=dev)
    cnt = torch.zeros(cap, dtype=torch.int64, device=dev)
    out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    cr, rr, step = clustering.CREATE * radius, clustering.RELAX * radius, math.sqrt(radius)
    ncent = pos = ambiguous = 0
    w = clustering.FIRST_WINDOW
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
        tol = clustering.TOL * (xsq + cn[best] + 1.0)
        # How far each centroid may have moved when row i comes: the rows
        # before it in the window that could move it, √radius / count each.
        onehot = torch.nn.functional.one_hot(best, ncent)
        before = torch.cumsum(onehot, dim=0) - onehot
        drift = before.to(dt) * (step / (cnt[:ncent] + 1).to(dt))[None, :]
        db = drift.gather(1, best[:, None])[:, 0]
        dmax = drift.max(dim=1).values
        hi = (torch.sqrt(bd) + db) ** 2 + tol
        if ncent > 1:
            second = D.scatter(1, best[:, None], float("inf")).min(dim=1).values
            nearest = torch.clamp(torch.sqrt(second) - dmax, min=0.0) ** 2 - tol > hi
        else:
            nearest = torch.ones_like(bd, dtype=torch.bool)
        move = nearest & (hi <= (cr if ncent < cap else radius))
        drop = torch.clamp(torch.sqrt(bd) - dmax, min=0.0) ** 2 - tol > rr
        if ncent < cap:
            drop = torch.zeros_like(drop)
        hit = torch.nonzero(~(move | drop))
        e = int(hit[0, 0]) if hit.numel() else m
        if e:
            rows = torch.nonzero(move[:e])[:, 0]
            j = best[rows]
            mj = torch.bincount(j, minlength=ncent)
            sums = torch.zeros((ncent, f), dtype=dt, device=dev).index_add_(0, j, R[rows].to(dt))
            moved = mj > 0
            n0 = cnt[:ncent].to(dt)
            C[:ncent] = torch.where(moved[:, None],
                                    (n0[:, None] * C[:ncent] + sums) / (n0 + mj.to(dt))[:, None],
                                    C[:ncent])
            cn[:ncent] = torch.where(moved, (C[:ncent] * C[:ncent]).sum(dim=1), cn[:ncent])
            cnt[:ncent] += mj
            out[pos + rows] = j
            pos += e
            w = min(2 * w, clustering.MAX_WINDOW) if e == m else max(clustering.FIRST_WINDOW, 2 * e)
            continue
        # The window's first row, decided alone from distances as they stand.
        d = D[0].double().cpu().numpy()
        kind, jj, amb = clustering._outcome(d, ncent, cap, radius, float(tol[0]),
                                            None if follow is None else int(follow[pos]))
        ambiguous += int(amb)
        x = X[pos].to(dt)
        if kind == "create":
            C[ncent], cn[ncent], cnt[ncent] = x, (x * x).sum(), 1
            ncent += 1
        elif kind == "move":
            cnt[jj] += 1
            C[jj] += (x - C[jj]) * (1.0 / cnt[jj].to(dt))
            cn[jj] = (C[jj] * C[jj]).sum()
        elif kind == "soft":
            cnt[jj] += 1
        out[pos] = jj
        pos += 1
        w = clustering.FIRST_WINDOW
    return clustering.Clustering(C[:ncent].clone(), out.cpu().numpy(), cnt[:ncent].cpu().numpy(),
                                 ambiguous)


class EigenJLIndex:
    """The reference index over the raw rows ``X [N, F]``: the graph from
    ``centroids [C, F]`` projected by ``P [F, r]``, λ of the projected rows,
    cosines of the raw ones."""

    def __init__(self, X: torch.Tensor, centroids: torch.Tensor, P: torch.Tensor, graph: dict,
                 prec: str = "f64", follow: torch.Tensor | None = None):
        tf32_off()
        self.prec = Precision(prec)
        self.X = X
        self.P = P.to(self.prec.dtype)
        self.nodes = self.project(centroids)                        # [C, r]
        self.L, self.graph_ties = followed_laplacian(self.nodes.T.contiguous(), graph,
                                                     graph["topk"], self.prec, follow)
        self.edges = graph_edges(self.L)
        raw, norms = [], []
        for s in range(0, X.shape[0], ROW_BLOCK):
            raw.append(raw_lambdas(self.project(X[s:s + ROW_BLOCK]), self.edges, self.prec))
            Xd = self.prec.operand(X[s:s + ROW_BLOCK]).to(self.prec.dtype)
            norms.append(torch.sqrt(torch.sum(Xd * Xd, dim=1)))
        raw = torch.cat(raw)
        self.mn, self.mx, self.rng = normalisation(raw)
        self.lambdas = (raw - self.mn) / self.rng
        self.norms = torch.cat(norms)
        self._Xop = None

    def project(self, rows: torch.Tensor) -> torch.Tensor:
        """``rows [.., F]`` in the λ space, one product in the precision."""
        return self.prec.matmul(rows, self.P).to(self.prec.dtype)

    def query_lambdas(self, Q: torch.Tensor) -> torch.Tensor:
        raw = raw_lambdas(self.project(Q), self.edges, self.prec)
        return torch.clamp((raw - self.mn) / self.rng, 0.0, 1.0)

    def scores(self, Q: torch.Tensor, alpha: float) -> torch.Tensor:
        """``[B, N]`` blended scores of the raw queries ``Q`` against every row."""
        if self._Xop is None:               # the rows as the products read them, made once
            self._Xop = self.prec.operand(self.X).T
        ql = self.query_lambdas(Q)
        Qd = self.prec.operand(Q)
        qn = torch.sqrt(torch.sum(Qd.to(self.prec.dtype) ** 2, dim=1))
        dots = (Qd @ self._Xop).to(self.prec.dtype)
        denom = qn[:, None] * self.norms[None, :]
        cos = torch.where(denom > 1e-12, dots / torch.clamp(denom, min=1e-12),
                          torch.zeros_like(dots))
        lam_sim = 1.0 - torch.clamp(torch.abs(self.lambdas[None, :] - ql[:, None]), max=1.0)
        return alpha * cos + (1.0 - alpha) * lam_sim
