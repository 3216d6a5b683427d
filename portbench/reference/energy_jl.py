"""Plain reference of the energymaps index built in a JL-projected λ space.

The build it judges (``build_energy`` with ``with_dims_reduction``): the
clustering scan over the raw F-wide rows; the scan's centroids projected
by an ``[F, r]`` Gaussian matrix, ``r`` by the JL rule on the number of
centroids; from the projected centroids the compression (none where the
token budget covers them), the bootstrap graph over the r projected
features, the diffusion and the split into sub-centroids ``[S, r]``; the
energy graph over the sub-centroids and their λ; each item's λ that of
the sub-centroid nearest its projected row; each query's λ that of the
sub-centroid nearest its projected query; the distances
``|λ − λq| + [|λ − λq| < 1e-9]·(1 − cos)·1e-9`` with the cosine over the
raw rows. All in float64 on the device the inputs are on, with TF32 off;
``precision="tf32"`` is the control (``reference.eigen.Precision``).

The pieces are the two references' own: the JL rule, the matrix's draw
and the batched clustering replay of ``reference.eigen_jl``; the
sub-centroid stages, the nearest-sub-centroid ties and the distances of
``reference.energy``. Here they meet: the rows and queries take their λ
in the projected space, their cosines in the raw one.

Nothing here imports the program, ``jax`` or the JAX package."""

from __future__ import annotations

import torch

from portbench.reference.eigen import Precision, followed_laplacian, graph_edges, normalisation, \
    raw_lambdas
from portbench.reference.eigen_jl import tf32_off
from portbench.reference.energy import EnergyIndex, _near_sets

ROW_BLOCK = 1 << 16                 # rows projected and given their sub-centroid at a time


class EnergyJLIndex(EnergyIndex):
    """The reference index over the raw rows ``X [N, F]`` from sub-centroids
    ``S [S, r]`` of the space projected by ``P [F, r]``: each row's λ that
    of the sub-centroid nearest its projection, cosines of the raw rows."""

    def __init__(self, X: torch.Tensor, S: torch.Tensor, P: torch.Tensor, graph: dict,
                 prec: str = "f64", follow: torch.Tensor | None = None):
        tf32_off()
        self.prec = Precision(prec)
        self.X = X
        self.P = P.to(self.prec.dtype)
        self.C = S.to(self.prec.dtype)
        L, self.graph_ties = followed_laplacian(self.C.T.contiguous(), graph, graph["topk"],
                                                self.prec, follow)
        raw = raw_lambdas(self.C, graph_edges(L), self.prec)
        mn, _, rng = normalisation(raw)
        self.sc_lams = ((raw - mn) / rng).double()
        best, near, norms = [], [], []
        for s in range(0, X.shape[0], ROW_BLOCK):
            b, m = _near_sets(self.project(X[s:s + ROW_BLOCK]), self.C)
            best.append(b)
            near.append(m)
            Xd = self.prec.operand(X[s:s + ROW_BLOCK])
            norms.append(torch.sqrt((Xd * Xd).sum(dim=1)))
        self.best, self.near, self.norms = torch.cat(best), torch.cat(near), torch.cat(norms)
        self.lambdas = self.sc_lams[self.best].clone()
        self.ambiguous_items = 0
        self.ambiguous_queries = 0
        self.q_lams = None

    def project(self, rows: torch.Tensor) -> torch.Tensor:
        """``rows [.., F]`` in the λ space, one product in the precision."""
        return self.prec.matmul(rows, self.P).to(self.prec.dtype)

    def prepare_queries(self, Q: torch.Tensor, answers) -> None:
        """Each raw query's λ, that of the sub-centroid nearest its
        projection (ties as ``EnergyIndex.prepare_queries`` settles them)."""
        super().prepare_queries(self.project(Q), answers)
