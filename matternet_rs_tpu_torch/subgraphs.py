"""Subgraphs: motif subgraphs and the hierarchy of centroid subgraphs
(twin of the reference's ``subgraphs.py``).

* motif subgraphs: each energy motif becomes a :class:`Subgraph` whose
  init data is the parent's columns of the motif's sub-centroids, with its
  own F×F feature Laplacian, the items it maps from and an optional
  Rayleigh-cohesion filter;
* the centroid hierarchy: round-robin mean reclustering, level by level,
  each level with its F×F Laplacian and the root items of each centroid.

Invariants: ``laplacian.init_data`` is ``[F, X]``, ``laplacian.matrix``
F×F, ``laplacian.nnodes`` X. Graphs are built on the parent graph's
device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from matternet_rs_tpu_torch.core import ArrowSpace
from matternet_rs_tpu_torch.graph import GraphLaplacian, GraphParams
from matternet_rs_tpu_torch.motives import MotiveConfig, spot_motives_energy
from matternet_rs_tpu_torch.ops import laplacian as lap_ops


@dataclasses.dataclass
class SubgraphConfig:
    motives: MotiveConfig = dataclasses.field(default_factory=MotiveConfig)
    rayleigh_max: Optional[float] = None
    min_size: int = 3


def _feature_graph(init_fx: torch.Tensor, params: GraphParams, n_items, energy=False):
    """``GraphLaplacian`` over the rows of ``init_fx [F, X]`` with ``nnodes = X``."""
    gl = lap_ops.build_laplacian_matrix(init_fx, params, n_items=n_items, energy=energy)
    return GraphLaplacian(matrix=gl.matrix, init_data=init_fx, nnodes=int(init_fx.shape[1]),
                          graph_params=params, energy=gl.energy)


@dataclasses.dataclass
class Subgraph:
    node_indices: list[int]
    item_indices: Optional[list[int]]
    laplacian: GraphLaplacian
    rayleigh: Optional[float] = None

    @classmethod
    def from_parent(cls, parent: GraphLaplacian, nodes: list[int],
                    n_items: Optional[int] = None) -> "Subgraph":
        """The parent's init-data columns ``nodes`` and their F×F Laplacian."""
        cols = torch.as_tensor(list(nodes), dtype=torch.long, device=parent.init_data.device)
        sub_init = parent.init_data[:, cols]
        local = _feature_graph(sub_init, parent.graph_params, n_items, energy=parent.energy)
        return cls(node_indices=list(nodes), item_indices=None, laplacian=local)

    def compute_rayleigh(self) -> None:
        """Rayleigh quotient of the all-ones feature vector."""
        f = self.laplacian.init_data.shape[0]
        if f == 0:
            self.rayleigh = float("inf")
            return
        ones = torch.ones(f, dtype=torch.float32, device=self.laplacian.init_data.device)
        self.rayleigh = float(self.laplacian.rayleigh_quotient(ones))


def spot_subg_motives(gl_energy: GraphLaplacian, aspace: ArrowSpace,
                      cfg: SubgraphConfig | None = None) -> list[Subgraph]:
    """One subgraph per energy motif of at least ``min_size`` items that
    maps to two or more sub-centroids, with its items."""
    cfg = cfg or SubgraphConfig()
    item_motifs = spot_motives_energy(gl_energy, aspace, cfg.motives)

    if aspace.centroid_map is not None:
        cmap = np.asarray(aspace.centroid_map)
    elif aspace.cluster_assignments is not None:
        ca = np.asarray(aspace.cluster_assignments)
        cmap = np.where(ca >= 0, ca, 0)
    else:
        raise ValueError("centroid_map or cluster_assignments required for energy subgraphs")

    n_centroids = gl_energy.init_data.shape[1]
    out: list[Subgraph] = []
    for items in item_motifs:
        if len(items) < cfg.min_size:
            continue
        cset = sorted({int(cmap[i]) for i in items if i < len(cmap) and cmap[i] < n_centroids})
        if len(cset) < 2:
            continue
        sg = Subgraph.from_parent(gl_energy, cset, n_items=aspace.nitems)
        sg.item_indices = list(items)
        if cfg.rayleigh_max is not None:
            sg.compute_rayleigh()
            if sg.rayleigh is not None and sg.rayleigh > cfg.rayleigh_max:
                continue
        out.append(sg)
    return out


# -- the centroid hierarchy ---------------------------------------------------


@dataclasses.dataclass
class CentroidGraphParams:
    eps: float = 0.5
    k: int = 16
    topk: int = 16
    p: float = 2.0
    sigma: Optional[float] = None
    normalise: bool = False
    sparsity_check: bool = False
    seed: Optional[int] = None
    min_centroids: int = 8
    max_depth: int = 2

    def graph_params(self) -> GraphParams:
        return GraphParams(eps=self.eps, k=self.k, topk=self.topk, p=self.p, sigma=self.sigma,
                           normalise=self.normalise, sparsity_check=self.sparsity_check)


@dataclasses.dataclass
class CentroidNode:
    graph: Subgraph
    parent_map: list[int]
    root_indices: list[list[int]]
    children: list["CentroidNode"] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CentroidHierarchy:
    root: CentroidNode
    levels: list[list[CentroidNode]]

    def level(self, depth: int) -> list[CentroidNode]:
        return self.levels[depth] if depth < len(self.levels) else []

    def count_subgraphs(self) -> int:
        return sum(len(lvl) for lvl in self.levels)

    def all_subgraphs(self) -> list[Subgraph]:
        return [node.graph for lvl in self.levels for node in lvl]


def recluster_centroids(centroids: np.ndarray, k: int,
                        seed: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
    """Round-robin labels ``i mod k`` and the mean of each label's rows
    (the reference's choice, not k-means; ``seed`` is unused)."""
    n, d = centroids.shape
    if n == 0:
        return np.zeros(0, np.int64), np.zeros((0, d), centroids.dtype)
    k_eff = min(k, n)
    labels = np.arange(n) % k_eff
    sums = np.zeros((k_eff, d), np.float64)
    np.add.at(sums, labels, centroids.astype(np.float64))
    counts = np.bincount(labels, minlength=k_eff)
    means = sums / np.maximum(counts, 1)[:, None]
    return labels.astype(np.int64), means.astype(centroids.dtype)


def _root_indices_from_aspace(aspace: ArrowSpace, n_root: int) -> list[list[int]]:
    if aspace.centroid_map is not None:
        ids = np.asarray(aspace.centroid_map)
    elif aspace.cluster_assignments is not None:
        ids = np.asarray(aspace.cluster_assignments)
    else:
        raise ValueError("centroid_map or cluster_assignments required")
    out: list[list[int]] = [[] for _ in range(n_root)]
    for item, cid in enumerate(ids):
        if 0 <= cid < n_root:
            out[int(cid)].append(item)
    return out


def build_centroid_hierarchy(gl_centroids: GraphLaplacian, aspace: ArrowSpace,
                             params: CentroidGraphParams | None = None) -> CentroidHierarchy:
    """The root graph over ``gl_centroids.init_data [F, X0]``, then down to
    ``max_depth`` levels: each node with at least ``min_centroids``
    centroids is reclustered into ``k`` round-robin means, a child graph
    over them, and each child's root items."""
    params = params or CentroidGraphParams()
    gp = params.graph_params()

    init_fx = gl_centroids.init_data
    x0 = int(init_fx.shape[1])
    root = CentroidNode(
        graph=Subgraph(list(range(x0)), None, _feature_graph(init_fx, gp, aspace.nitems)),
        parent_map=list(range(x0)),
        root_indices=_root_indices_from_aspace(aspace, x0),
    )
    hierarchy = CentroidHierarchy(root=root, levels=[[] for _ in range(max(params.max_depth, 1))])

    def collect(node: CentroidNode, depth: int):
        if depth >= len(hierarchy.levels):
            hierarchy.levels.extend([] for _ in range(depth + 1 - len(hierarchy.levels)))
        hierarchy.levels[depth].append(node)
        if depth + 1 >= params.max_depth:
            return
        if node.graph.laplacian.nnodes < params.min_centroids:
            return
        cents_xf = node.graph.laplacian.init_data.cpu().numpy().T
        labels, subs_xf = recluster_centroids(cents_xf, params.k, params.seed)
        x_next = subs_xf.shape[0]
        if x_next == 0:
            return
        next_root: list[list[int]] = [[] for _ in range(x_next)]
        for parent_cid, items in enumerate(node.root_indices):
            child = int(labels[parent_cid])
            if child < x_next:
                next_root[child].extend(items)
        subs_fx = torch.from_numpy(np.ascontiguousarray(subs_xf.T)).to(init_fx.device)
        child_node = CentroidNode(
            graph=Subgraph(list(range(x_next)), None, _feature_graph(subs_fx, gp, aspace.nitems)),
            parent_map=[int(v) for v in labels],
            root_indices=next_root,
        )
        node.children.append(child_node)
        collect(child_node, depth + 1)

    collect(root, 0)
    return hierarchy


def spot_subg_centroids(gl_centroids: GraphLaplacian, aspace: ArrowSpace,
                        params: CentroidGraphParams | None = None) -> list[Subgraph]:
    """Every subgraph of the hierarchy, level by level."""
    return build_centroid_hierarchy(gl_centroids, aspace, params).all_subgraphs()
