"""Fixed-degree (ELL) sparse graphs and their products, for large-F graphs
(twin of the reference's ``ops/csr.py``).

Every graph this package builds is top-k capped, so the padded
``indices/weights [n, k]`` layout is exact: weight 0 marks an empty slot,
whose index may be anything (the direct build writes −1). The products go
through kernel F (:mod:`..ops.kernels.spmv_ell`) on a CUDA tensor and
through its plain version on the CPU; the ``[n, k, m]`` gather that
:func:`spmv_ell_scan` exists to avoid in the reference never exists here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from matternet_rs_tpu_torch.backend import resolve_device
from matternet_rs_tpu_torch.ops.kernels import spmv_ell as fk
from matternet_rs_tpu_torch.ops.search import topk_stable


def _scatter_max_dense(indices: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Dense ``[n, n]`` adjacency with ``W[i, indices[i, s]] = max`` of the
    weights written there; empty slots (weight 0) write nothing."""
    n = indices.shape[0]
    live = weights != 0
    cols = torch.where(live, indices, 0).long()
    vals = torch.where(live, weights, torch.zeros_like(weights))
    return torch.zeros((n, n), dtype=torch.float32, device=weights.device).scatter_reduce(
        1, cols, vals, reduce="amax", include_self=True
    )


@dataclasses.dataclass
class SparseGraph:
    """Fixed-degree (ELL) symmetric graph: ``indices/weights [n, k]``,
    padding marked by weight 0."""

    indices: torch.Tensor     # [n, k] int32 neighbour ids
    weights: torch.Tensor     # [n, k] f32, 0 = padding
    n_nodes: int

    @classmethod
    def from_edges(cls, edges: list[tuple[int, int, float]], n_nodes: int,
                   max_degree: int | None = None, device=None) -> "SparseGraph":
        """Build from COO ``(u, v, w)`` undirected edges; duplicate edges
        keep the larger weight, and a row over capacity keeps its strongest
        edges (lowest id first among equals)."""
        dev = resolve_device(device)
        adj: list[dict[int, float]] = [dict() for _ in range(n_nodes)]
        for u, v, w in edges:
            if u == v:
                continue
            adj[u][v] = max(adj[u].get(v, 0.0), w)
            adj[v][u] = max(adj[v].get(u, 0.0), w)
        k = max(max_degree or max((len(a) for a in adj), default=1), 1)
        idx = np.zeros((n_nodes, k), np.int32)
        wts = np.zeros((n_nodes, k), np.float32)
        for i, a in enumerate(adj):
            items = sorted(a.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
            for slot, (j, w) in enumerate(items):
                idx[i, slot] = j
                wts[i, slot] = w
        return cls(torch.from_numpy(idx).to(dev), torch.from_numpy(wts).to(dev), n_nodes)

    @classmethod
    def from_dense(cls, W, max_degree: int | None = None, device=None) -> "SparseGraph":
        dev = resolve_device(device)
        W = W.detach().cpu().numpy() if isinstance(W, torch.Tensor) else np.asarray(W)
        n = W.shape[0]
        degs = (np.abs(W) > 1e-12).sum(1)
        k = int(max_degree or max(degs.max(), 1))
        idx = np.zeros((n, k), np.int32)
        wts = np.zeros((n, k), np.float32)
        for i in range(n):
            nbrs = np.nonzero(np.abs(W[i]) > 1e-12)[0]
            if len(nbrs) > k:   # keep the strongest, not the lowest ids
                nbrs = nbrs[np.argsort(-np.abs(W[i, nbrs]), kind="stable")[:k]]
            idx[i, : len(nbrs)] = nbrs
            wts[i, : len(nbrs)] = W[i, nbrs]
        return cls(torch.from_numpy(idx).to(dev), torch.from_numpy(wts).to(dev), n)

    def degrees(self) -> torch.Tensor:
        return torch.sum(self.weights, dim=1)

    def to_dense_adjacency(self) -> torch.Tensor:
        return _scatter_max_dense(self.indices, self.weights)

    def to_laplacian_dense(self) -> torch.Tensor:
        """``L = D - W`` densified."""
        W = self.to_dense_adjacency()
        return torch.diag(torch.sum(W, dim=1)) - W


@dataclasses.dataclass
class EllLaplacian:
    """Exact ELL form of a graph Laplacian: ``L = diag(diag) - W`` with the
    symmetric non-negative adjacency W as ``indices/weights [n, k]``
    (zero-weight padding) and the diagonal kept apart (the degree for
    ``L = D - W``, 1 for ``L_sym``)."""

    indices: torch.Tensor     # [n, k] int32
    weights: torch.Tensor     # [n, k] f32 ≥ 0, 0 = padding
    diag: torch.Tensor        # [n] f32 diagonal of L
    _checked: bool = dataclasses.field(default=False, repr=False, compare=False)

    def check(self) -> "EllLaplacian":
        """Validate the slots once (:func:`..kernels.spmv_ell.check_ell`:
        one scalar read back); later calls are free."""
        if not self._checked:
            fk.check_ell(self.indices, self.weights)
            self._checked = True
        return self

    @property
    def n_nodes(self) -> int:
        return int(self.indices.shape[0])

    @property
    def max_degree(self) -> int:
        return int(self.indices.shape[1])

    @property
    def shape(self) -> tuple[int, int]:
        """Duck-types the dense ``[n, n]`` matrix for dimension checks."""
        return (self.n_nodes, self.n_nodes)

    @property
    def device(self) -> torch.device:
        return self.weights.device

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.indices, self.weights, self.diag))

    def matvec(self, V: torch.Tensor) -> torch.Tensor:
        """``L @ V = diag∘V − W@V`` for ``V [n]`` or ``[n, m]``."""
        return _apply(self.check().indices, self.weights, V, self.diag, checked=True)

    def to_dense(self) -> torch.Tensor:
        return torch.diag(self.diag) - _scatter_max_dense(self.indices, self.weights)


def _ell_required_degree(L: torch.Tensor) -> torch.Tensor:
    W = torch.clamp(-L, min=0.0)
    W = W - torch.diag(torch.diag(W))
    return torch.max(torch.sum(W > 0.0, dim=1))


def _ell_extract(L: torch.Tensor, k: int):
    W = torch.clamp(-L, min=0.0)
    W = W - torch.diag(torch.diag(W))
    w, idx = topk_stable(W, k)
    return idx.to(torch.int32), w, torch.diag(L)


def ell_from_dense_laplacian(L: torch.Tensor, max_degree: int | None = None) -> EllLaplacian:
    """Exact ELL extraction from a dense Laplacian, on its device.
    ``max_degree=None`` takes the true maximum row degree first (one scalar
    read back from the device) so no edge is dropped. Positive
    off-diagonals would be rectified away; the builders never make them."""
    L = L.to(torch.float32)
    k = int(_ell_required_degree(L)) if max_degree is None else int(max_degree)
    k = max(min(k, L.shape[0] - 1), 1)
    idx, w, diag = _ell_extract(L, k)
    return EllLaplacian(indices=idx.contiguous(), weights=w.contiguous(), diag=diag.contiguous())


def _apply(indices, weights, x, d, checked: bool):
    X = (x[:, None] if x.ndim == 1 else x).contiguous()
    out = fk.spmv_ell(indices, weights, X, d, checked=checked)
    return out[:, 0] if x.ndim == 1 else out


def spmv_ell(indices, weights, x, *, checked: bool = False) -> torch.Tensor:
    """``W @ x`` in ELL layout; ``x [n]`` or ``[n, m]``. Empty slots
    (weight 0) contribute nothing."""
    return _apply(indices, weights, x, None, checked)


def laplacian_spmv_ell(indices, weights, x, *, checked: bool = False) -> torch.Tensor:
    """``L @ x = deg∘x - W@x`` without densifying."""
    return _apply(indices, weights, x, torch.sum(weights, dim=1), checked)


def spmv_ell_scan(indices, weights, X, *, checked: bool = False) -> torch.Tensor:
    """``W @ X`` for a wide right-hand side ``X [n, m]``. The reference
    scans the slots to keep the ``[n, k, m]`` gather out of memory; here
    that gather never exists on either route (kernel F reads rows in
    place, the plain version accumulates slot by slot), so this is
    :func:`spmv_ell`, kept under the reference's name."""
    return _apply(indices, weights, X, None, checked)
