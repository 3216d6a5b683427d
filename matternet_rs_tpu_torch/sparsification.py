"""SF-GRASS spectral sparsification (twin of the reference's
``sparsification.py``; numpy, at graph scale).

A graph whose average degree is below 10 is left as it is. Otherwise each
node keeps the top ``target_ratio`` share of its edges by ``w·√(dᵢ·dⱼ)``,
at least one.
"""

from __future__ import annotations

import numpy as np


class SfGrassSparsifier:
    def __init__(self, target_ratio: float = 0.5):
        self.target_ratio = float(np.clip(target_ratio, 0.1, 1.0))

    def with_target_ratio(self, ratio: float) -> "SfGrassSparsifier":
        self.target_ratio = float(np.clip(ratio, 0.1, 1.0))
        return self

    def _keep(self, n_neighbors: int) -> int:
        return min(max(int(np.ceil(n_neighbors * self.target_ratio)), 1), n_neighbors)

    def sparsify_adjacency(self, W: np.ndarray) -> np.ndarray:
        """Dense adjacency → the per-row kept adjacency (not symmetric;
        callers symmetrise as they need)."""
        W = np.asarray(W, np.float64)
        n = W.shape[0]
        mask = W > 1e-12
        degrees = mask.sum(axis=1)
        if int(degrees.sum()) / max(n, 1) < 10.0:
            return W.copy()
        out = np.zeros_like(W)
        for i in range(n):
            nbrs = np.nonzero(mask[i])[0]
            if nbrs.size == 0:
                continue
            score = W[i, nbrs] * np.sqrt(degrees[i] * degrees[nbrs])
            top = nbrs[np.argsort(-score, kind="stable")[:self._keep(nbrs.size)]]
            out[i, top] = W[i, top]
        return out

    def sparsify_graph(self, adj_rows: list[list[tuple[int, float]]],
                       n_nodes: int) -> list[list[tuple[int, float]]]:
        """The same on adjacency lists of ``(neighbour, weight)``."""
        degrees = [len(r) for r in adj_rows]
        if sum(degrees) / max(n_nodes, 1) < 10.0:
            return [list(r) for r in adj_rows]
        out = []
        for i, neighbors in enumerate(adj_rows):
            if not neighbors:
                out.append([])
                continue
            scored = sorted(
                ((j, w, w * np.sqrt(degrees[i] * degrees[j])) for j, w in neighbors),
                key=lambda t: -t[2],
            )
            out.append([(j, w) for j, w, _ in scored[:self._keep(len(neighbors))]])
        return out
