"""Graph containers: parameters and the Laplacian wrapper (twin of
``matternet_rs_tpu/graph.py``).

The Laplacian is a dense ``[n, n]`` tensor over feature- or centroid-scale
graphs, or — for node counts from ``DIRECT_ELL_N``, where ``[n, n]`` is a
memory wall — an ELL-backed graph (``matrix=None``) whose exact
fixed-degree form (:class:`~matternet_rs_tpu_torch.ops.csr.EllLaplacian`)
is all that exists. A dense graph extracts its ELL form once, on demand,
for the sparse λ route and the sparse eigensolver.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from matternet_rs_tpu_torch.ops import csr
from matternet_rs_tpu_torch.ops._mm import mm


@dataclasses.dataclass(frozen=True)
class GraphParams:
    """Graph construction parameters (same fields and defaults as the
    reference)."""

    eps: float = 0.5
    k: int = 10
    topk: int = 10
    p: float = 2.0
    sigma: Optional[float] = None
    normalise: bool = False
    sparsity_check: bool = True

    def sigma_value(self) -> float:
        return 1.0 if self.sigma is None else float(self.sigma)


@dataclasses.dataclass
class GraphLaplacian:
    """Graph Laplacian ``L = D - W`` (or ``L_sym``) over n nodes.

    ``matrix`` is the dense ``[n, n]`` tensor, or ``None`` for an
    ELL-backed graph (``_ell_cache`` then holds its only form);
    ``init_data`` the node profiles it was built from; ``nnodes`` the item
    count of the raw data.
    """

    matrix: Optional[torch.Tensor]
    init_data: torch.Tensor
    nnodes: int
    graph_params: GraphParams
    energy: bool = False
    _ell_cache: Optional[csr.EllLaplacian] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @classmethod
    def from_ell(cls, ell: csr.EllLaplacian, init_data, nnodes: int,
                 graph_params: GraphParams, energy: bool = False) -> "GraphLaplacian":
        """ELL-backed Laplacian: O(n·k) memory, no dense matrix."""
        return cls(matrix=None, init_data=init_data, nnodes=nnodes,
                   graph_params=graph_params, energy=energy, _ell_cache=ell)

    @property
    def is_ell_backed(self) -> bool:
        return self.matrix is None

    def ell(self) -> csr.EllLaplacian:
        """Cached exact ELL form. Extraction costs one top-k pass over
        ``[n, n]`` and one scalar read back from the device; the cache
        spreads that over every λ batch and query against this graph. An
        ELL-backed graph returns its own form."""
        if self._ell_cache is None:
            self._ell_cache = csr.ell_from_dense_laplacian(self.matrix)
        return self._ell_cache

    def dense(self) -> torch.Tensor:
        """The dense ``[n, n]`` matrix; densifies an ELL-backed graph on
        demand (O(n²) memory: small n only)."""
        if self.matrix is not None:
            return self.matrix
        return self.ell().to_dense()

    @property
    def shape(self) -> tuple[int, int]:
        if self.matrix is None:
            return self.ell().shape
        return tuple(self.matrix.shape)

    def nnz(self, tol: float = 0.0) -> int:
        if self.matrix is None:
            e = self.ell()
            return int((e.weights > tol).sum()) + int((e.diag.abs() > tol).sum())
        return int((self.matrix.abs() > tol).sum())

    @staticmethod
    def sparsity_of(matrix: torch.Tensor, tol: float = 0.0) -> float:
        n = matrix.shape[0] * matrix.shape[1]
        return 1.0 - int((matrix.abs() > tol).sum()) / max(n, 1)

    def sparsity(self, tol: float = 0.0) -> float:
        if self.matrix is None:
            n = self.shape[0]
            return 1.0 - self.nnz(tol) / max(n * n, 1)
        return self.sparsity_of(self.matrix, tol)

    def multiply_vector(self, x: torch.Tensor) -> torch.Tensor:
        """``L @ x``. An ELL-backed graph applies the fixed-degree product
        (kernel F on the card) with its stored diagonal, which is 1 for
        ``L_sym`` and not the row degree."""
        if self.matrix is None:
            return self.ell().matvec(x)
        return mm(self.matrix, x)

    def rayleigh_quotient(self, x: torch.Tensor) -> torch.Tensor:
        """``xᵀLx / xᵀx`` (0 for a zero vector)."""
        num = torch.dot(x, self.multiply_vector(x))
        den = torch.dot(x, x)
        return torch.where(den > 1e-12, num / torch.clamp(den, min=1e-12),
                           torch.zeros_like(den))

    def adjacency(self) -> torch.Tensor:
        """``W_ij = max(-L_ij, 0)`` off the diagonal. Densifies an
        ELL-backed graph."""
        w = torch.clamp(-self.dense(), min=0.0)
        return w - torch.diag(torch.diag(w))

    def degrees(self) -> torch.Tensor:
        if self.matrix is None:
            return self.ell().diag
        return torch.diag(self.matrix)

    def neighbors_of(self, i: int, tol: float = 1e-12) -> np.ndarray:
        if self.matrix is None:
            e = self.ell()
            idx = e.indices[i].cpu().numpy()
            w = e.weights[i].cpu().numpy()
            return np.unique(idx[w > tol])
        return np.nonzero(self.adjacency()[i].cpu().numpy() > tol)[0]

    def verify_properties(self, atol: float = 1e-4) -> dict:
        """Symmetry, ~zero row sums (unnormalised graphs), non-negative
        diagonal, as booleans."""
        m = self.dense().cpu().numpy()
        return {
            "symmetric": bool(np.allclose(m, m.T, atol=atol)),
            "row_sums_zero": bool(np.allclose(m.sum(axis=1), 0.0, atol=atol)),
            "diag_nonneg": bool((np.diag(m) >= -atol).all()),
        }

    def statistics(self) -> dict:
        """Degree, nnz and sparsity statistics."""
        deg = self.degrees().cpu().numpy()
        return {
            "nnodes": self.shape[0],
            "nnz": self.nnz(),
            "sparsity": self.sparsity(),
            "min_degree": float(deg.min()) if deg.size else 0.0,
            "max_degree": float(deg.max()) if deg.size else 0.0,
            "mean_degree": float(deg.mean()) if deg.size else 0.0,
        }


class GraphFactory:
    """The reference's ``GraphFactory`` namespace: thin aliases over
    :mod:`.ops.laplacian`."""

    @staticmethod
    def build_laplacian_matrix_from_k_cluster(clustered, eps, k, topk, p, sigma_override=None,
                                              normalise=False, sparsity_check=False,
                                              n_items=None) -> "GraphLaplacian":
        from matternet_rs_tpu_torch.ops import laplacian as lap_ops

        params = GraphParams(eps=eps, k=k, topk=topk, p=p, sigma=sigma_override,
                             normalise=normalise, sparsity_check=sparsity_check)
        c = clustered if isinstance(clustered, torch.Tensor) else torch.from_numpy(
            np.array(clustered, np.float32))
        return lap_ops.build_laplacian_from_k_cluster(
            c, params, n_items=n_items if n_items is not None else c.shape[0])

    @staticmethod
    def build_spectral_laplacian(aspace, graph_laplacian) -> None:
        from matternet_rs_tpu_torch.ops import laplacian as lap_ops

        aspace.signals = lap_ops.build_spectral_laplacian(graph_laplacian, aspace.nitems)
