"""Graph containers: parameters and the dense Laplacian (twin of
``matternet_rs_tpu/graph.py``).

The Laplacian is a dense ``[n, n]`` tensor over feature- or centroid-scale
graphs. The ELL-backed graph (node counts ≥ ``DIRECT_ELL_N``, or the sparse
λ route for F > 2048) is not ported yet: ROADMAP.md Queue 1 item 5 carries
it, and every route that would need it raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from matternet_rs_tpu_torch.ops._mm import mm

ELL_NOT_PORTED = (
    "the ELL-backed graph (node counts >= 8192, or F > 2048) is not ported "
    "yet: ROADMAP.md Queue 1 item 5"
)


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
    """Dense graph Laplacian ``L = D - W`` (or ``L_sym``) over n nodes.

    ``matrix`` is the ``[n, n]`` tensor; ``init_data`` the node profiles it
    was built from; ``nnodes`` the item count of the raw data.
    """

    matrix: torch.Tensor
    init_data: torch.Tensor
    nnodes: int
    graph_params: GraphParams
    energy: bool = False

    is_ell_backed = False

    def ell(self):
        raise NotImplementedError(ELL_NOT_PORTED)

    def dense(self) -> torch.Tensor:
        return self.matrix

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.matrix.shape)

    def nnz(self, tol: float = 0.0) -> int:
        return int((self.matrix.abs() > tol).sum())

    @staticmethod
    def sparsity_of(matrix: torch.Tensor, tol: float = 0.0) -> float:
        n = matrix.shape[0] * matrix.shape[1]
        return 1.0 - int((matrix.abs() > tol).sum()) / max(n, 1)

    def sparsity(self, tol: float = 0.0) -> float:
        return self.sparsity_of(self.matrix, tol)

    def multiply_vector(self, x: torch.Tensor) -> torch.Tensor:
        return mm(self.matrix, x)

    def adjacency(self) -> torch.Tensor:
        """``W_ij = max(-L_ij, 0)`` off the diagonal."""
        w = torch.clamp(-self.matrix, min=0.0)
        return w - torch.diag(torch.diag(w))

    def degrees(self) -> torch.Tensor:
        return torch.diag(self.matrix)
