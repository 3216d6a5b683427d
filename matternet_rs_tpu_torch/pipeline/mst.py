"""Stage B1: thickness-weighted MST skeleton → trunk → 1-D order (twin of
the reference's ``pipeline/mst.py``).

The ``[C, C]`` candidate distances are one pairwise pass on the state's
device (Bhattacharyya tiled, :mod:`..ops.distance`); each row's nearest
``k + 1`` come from a stable sort there, in row blocks, which gives the
order of the reference's host ``np.argsort(D, kind="stable")`` over the
same values (their float64 widening keeps order and ties), and only those
columns cross to the host. Prim's MST, the double-BFS trunk and the DFS
order run on the host in float64, at centroid scale.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque

import numpy as np
import torch

from matternet_rs_tpu_torch.ops import distance as dist_ops
from matternet_rs_tpu_torch.pipeline.centroid import CentroidState

BHATTACHARYYA = "bhattacharyya"
EUCLIDEAN = "euclidean"
SQEUCLIDEAN = "sqeuclidean"

THICKNESS_MEAN = "mean"
THICKNESS_MIN = "min"
THICKNESS_MAX = "max"
THICKNESS_GEOMETRIC = "geometric_mean"
THICKNESS_NONE = "none"

# Elements of one row block of the candidate sort (its values and ids).
SORT_BLOCK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class MSTConfig:
    k_neighbors: int = 8
    distance_metric: str = BHATTACHARYYA
    thickness_weight: str = THICKNESS_MEAN
    compute_trunk: bool = True

    @classmethod
    def high_dimensional(cls) -> "MSTConfig":
        return cls(k_neighbors=16)

    @classmethod
    def prototype(cls) -> "MSTConfig":
        return cls(k_neighbors=4, distance_metric=SQEUCLIDEAN,
                   thickness_weight=THICKNESS_NONE, compute_trunk=False)


@dataclasses.dataclass
class Edge:
    u: int
    v: int
    distance: float
    thickness_u: float
    thickness_v: float
    cost: float

    def contains(self, node: int) -> bool:
        return node == self.u or node == self.v

    def other(self, node: int):
        """The opposite endpoint, or None if ``node`` is not on the edge."""
        if node == self.u:
            return self.v
        if node == self.v:
            return self.u
        return None


@dataclasses.dataclass
class MSTOutput:
    candidate_edges: list[Edge]
    mst_edges: list[Edge]
    centroid_order: np.ndarray
    trunk_nodes: np.ndarray
    trunk_edges: set[tuple[int, int]]
    thickness: np.ndarray
    total_weight: float
    nodes_in_mst: int

    def is_connected(self) -> bool:
        """Whether the tree reached every centroid."""
        return self.nodes_in_mst == len(self.centroid_order)


def nearest_columns(D: torch.Tensor, m: int, block_elems: int = SORT_BLOCK_ELEMS):
    """The first ``m`` columns of each row's stable ascending order of
    ``D``, as host ``(ids [C, m] int64, values [C, m] float64)``; ``+ 0.0``
    first makes −0.0 equal to 0.0 in the sort, as in numpy's."""
    c = D.shape[0]
    blk = max(1, block_elems // max(D.shape[1], 1))
    ids, vals = [], []
    for s in range(0, c, blk):
        v, i = torch.sort(D[s:s + blk] + 0.0, dim=1, stable=True)
        ids.append(i[:, :m].cpu())
        vals.append(v[:, :m].cpu())
    return torch.cat(ids).numpy(), torch.cat(vals).numpy().astype(np.float64)


class MSTStage:
    def __init__(self, config: MSTConfig | None = None):
        self.config = config or MSTConfig()

    def execute(self, state: CentroidState) -> MSTOutput:
        cfg = self.config
        c = state.num_centroids
        thickness = state.get_thickness().cpu().numpy().astype(np.float64)
        k = min(cfg.k_neighbors, c - 1)
        ids, vals = nearest_columns(self._pairwise(state), k + 1)
        candidate_edges = []
        for i in range(c):
            cnt = 0
            for j, d in zip(ids[i], vals[i]):
                if cnt >= k:
                    break
                if j == i:
                    continue
                candidate_edges.append(Edge(i, int(j), float(d), thickness[i], thickness[j],
                                            self._edge_cost(float(d), thickness[i], thickness[j])))
                cnt += 1

        mst_edges, total_weight, nodes_in_mst = self._prim(candidate_edges, c)
        trunk_nodes = np.array([], np.int64)
        if cfg.compute_trunk and nodes_in_mst > 1:
            trunk_nodes = self._trunk(mst_edges, thickness, c)
        trunk_edges = set()
        for a, b in zip(trunk_nodes[:-1], trunk_nodes[1:]):
            trunk_edges.add((int(a), int(b)))
            trunk_edges.add((int(b), int(a)))
        return MSTOutput(
            candidate_edges=candidate_edges, mst_edges=mst_edges,
            centroid_order=self._dfs_ordering(mst_edges, thickness, c),
            trunk_nodes=trunk_nodes, trunk_edges=trunk_edges, thickness=thickness,
            total_weight=total_weight, nodes_in_mst=nodes_in_mst,
        )

    def _pairwise(self, state: CentroidState) -> torch.Tensor:
        """``[C, C]`` float32 distances on the state's device."""
        if self.config.distance_metric == BHATTACHARYYA:
            return dist_ops.bhattacharyya_pairwise(state.means, state.variances)
        if self.config.distance_metric == EUCLIDEAN:
            return dist_ops.pairwise_euclidean(state.means)
        return dist_ops.pairwise_sqeuclidean(state.means)

    def _edge_cost(self, d: float, ti: float, tj: float) -> float:
        """Surface cost ``d · φ(tᵢ, tⱼ)``."""
        tw = self.config.thickness_weight
        if tw == THICKNESS_NONE:
            return d
        if tw == THICKNESS_MEAN:
            phi = (ti + tj) / 2.0
        elif tw == THICKNESS_MIN:
            phi = min(ti, tj)
        elif tw == THICKNESS_MAX:
            phi = max(ti, tj)
        elif tw == THICKNESS_GEOMETRIC:
            phi = float(np.sqrt(max(ti * tj, 0.0)))
        else:
            raise ValueError(f"unknown thickness weight {tw!r}")
        return d * phi

    @staticmethod
    def _prim(edges: list[Edge], n: int) -> tuple[list[Edge], float, int]:
        """Heap Prim from node 0; returns the tree's edges, weight and the
        nodes it reached."""
        adj: list[list[tuple[int, float, int]]] = [[] for _ in range(n)]
        for idx, e in enumerate(edges):
            adj[e.u].append((e.v, e.cost, idx))
            adj[e.v].append((e.u, e.cost, idx))
        in_mst = [False] * n
        in_mst[0] = True
        heap = [(cost, nb, idx) for nb, cost, idx in adj[0]]
        heapq.heapify(heap)
        mst_idx, total = [], 0.0
        while heap:
            cost, node, idx = heapq.heappop(heap)
            if in_mst[node]:
                continue
            in_mst[node] = True
            mst_idx.append(idx)
            total += cost
            for nb, nb_cost, nb_idx in adj[node]:
                if not in_mst[nb]:
                    heapq.heappush(heap, (nb_cost, nb, nb_idx))
        return [edges[i] for i in mst_idx], total, sum(in_mst)

    def _trunk(self, mst_edges, thickness, n) -> np.ndarray:
        """The tree's diameter by a double BFS from the thickest node."""
        if not mst_edges:
            return np.array([], np.int64)
        adj: list[list[tuple[int, float]]] = [[] for _ in range(n)]
        for e in mst_edges:
            adj[e.u].append((e.v, e.cost))
            adj[e.v].append((e.u, e.cost))
        far1, _ = self._bfs_farthest(adj, int(np.argmax(thickness)), n)
        far2, dist = self._bfs_farthest(adj, far1, n)
        return self._reconstruct_path(adj, far1, far2, dist)

    @staticmethod
    def _bfs_farthest(adj, start, n):
        dist = np.full(n, np.inf)
        dist[start] = 0.0
        q = deque([start])
        while q:
            u = q.popleft()
            for v, cost in adj[u]:
                nd = dist[u] + cost
                if nd < dist[v]:
                    dist[v] = nd
                    q.append(v)
        finite = np.where(np.isfinite(dist))[0]
        far = int(finite[np.argmax(dist[finite])]) if finite.size else start
        return far, dist

    @staticmethod
    def _reconstruct_path(adj, start, end, dist) -> np.ndarray:
        """Walk back from ``end`` along the distance gradient."""
        path, cur = [end], end
        while cur != start:
            nxt, best_residual = None, np.inf
            for nb, cost in adj[cur]:
                residual = abs(dist[cur] - (dist[nb] + cost))
                if residual < best_residual:
                    best_residual, nxt = residual, nb
            if nxt is None or best_residual >= 1e-3:
                break
            path.append(nxt)
            cur = nxt
        path.reverse()
        return np.asarray(path, np.int64)

    @staticmethod
    def _dfs_ordering(mst_edges, thickness, n) -> np.ndarray:
        """Iterative DFS from the thickest node, children thick → thin."""
        if not mst_edges:
            return np.arange(n, dtype=np.int64)
        adj: list[list[int]] = [[] for _ in range(n)]
        for e in mst_edges:
            adj[e.u].append(e.v)
            adj[e.v].append(e.u)
        for nbrs in adj:
            nbrs.sort(key=lambda j: -thickness[j])
        order, visited = [], [False] * n
        stack = [int(np.argmax(thickness))]
        while stack:
            node = stack.pop()
            if visited[node]:
                continue
            visited[node] = True
            order.append(node)
            for nb in reversed(adj[node]):
                if not visited[nb]:
                    stack.append(nb)
        return np.asarray(order, np.int64)
