"""Motif spotting by triangle density (twin of the reference's
``motives.py``).

Top-L neighbour lists from the graph's off-diagonals, per-node triangle
counts and clustering coefficients ``2T/(k(k−1))``, seeds where both pass
their minimum, greedy growth by triangle gain, Jaccard deduplication. The
common-neighbour counts are one full-f32 product on the graph's device;
the set-based growth runs on the host, as the reference's. The energy
variant maps its motifs to items through ``centroid_map``, reading the
energy graph's node ids as ``centroid_map`` values, as the reference does
(that graph is F×F over features).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from matternet_rs_tpu_torch.core import ArrowSpace
from matternet_rs_tpu_torch.graph import GraphLaplacian
from matternet_rs_tpu_torch.ops._mm import mm


@dataclasses.dataclass(frozen=True)
class MotiveConfig:
    """The reference's defaults."""

    top_l: int = 16
    min_triangles: int = 2
    min_clust: float = 0.4
    max_motif_size: int = 32
    max_sets: int = 256
    jaccard_dedup: float = 0.8


def jaccard(a: set[int], b: set[int]) -> float:
    inter = len(a & b)
    union = len(a) + len(b) - inter
    return inter / union if union else 0.0


def _neighbor_lists(W: np.ndarray, top_l: int, by_weight: bool) -> list[np.ndarray]:
    """Sorted neighbour lists per node: the ``top_l`` strongest edges
    (``by_weight``, the eigen variant) or the first ``top_l`` by index (the
    energy variant)."""
    out = []
    for i in range(W.shape[0]):
        nbrs = np.nonzero(W[i] > 1e-12)[0]
        nbrs = nbrs[nbrs != i]
        if by_weight and len(nbrs) > top_l:
            nbrs = nbrs[np.argsort(-W[i, nbrs], kind="stable")[:top_l]]
        ids = np.sort(nbrs)
        if not by_weight and len(ids) > top_l:
            ids = ids[:top_l]
        out.append(ids)
    return out


def _triangle_stats(neigh_idx: list[np.ndarray], n: int, device):
    """Per-node triangle counts and clustering coefficients. With ``B`` the
    binary neighbour matrix (zero diagonal), ``(B Bᵀ)[i, j]`` counts the
    common neighbours of i and j, so ``tri[i] = Σ_{j>i} B[i,j]·(B Bᵀ)[i,j]``:
    one product (integers, exact in f32 below 2²⁴) on ``device``."""
    B = np.zeros((n, n), np.float32)
    for i, ids in enumerate(neigh_idx):
        B[i, ids] = 1.0
    Bt = torch.from_numpy(B).to(device)
    common = mm(Bt, Bt.T).cpu().numpy()
    upper = np.triu(B, k=1)
    tri = np.rint((upper * common).sum(axis=1)).astype(np.int64)

    k = np.array([len(ids) for ids in neigh_idx])
    clust = np.where(k >= 2, 2.0 * tri / np.maximum(k * (k - 1), 1), 0.0)
    tri = np.where(k >= 2, tri, 0)
    return tri, clust


def _greedy_expand(seed: int, neigh_idx, sets, cfg: MotiveConfig) -> set[int] | None:
    """Grow a motif from ``seed`` by the candidate that closes the most
    triangles (the lowest id on ties); ``None`` below three nodes."""
    motif = {seed}
    while len(motif) < cfg.max_motif_size:
        cand = set()
        for u in motif:
            cand.update(v for v in neigh_idx[u] if v not in motif)
        if not cand:
            break
        best_u, best_gain = None, -1
        for u in sorted(cand):
            s_nbrs = sorted(v for v in neigh_idx[u] if v in motif)
            edges = 0
            for pos, ui in enumerate(s_nbrs):
                edges += len(sets[ui] & set(s_nbrs[pos + 1:]))
            if edges > best_gain:
                best_gain = edges
                best_u = u
        if best_u is None:
            break
        motif.add(best_u)
    return motif if len(motif) >= 3 else None


def _spot(neigh_idx, n: int, cfg: MotiveConfig, device) -> list[list[int]]:
    sets = [set(ids.tolist()) for ids in neigh_idx]
    tri, clust = _triangle_stats(neigh_idx, n, device)
    seeds = [i for i in range(n) if tri[i] >= cfg.min_triangles and clust[i] >= cfg.min_clust]
    seeds.sort(key=lambda i: (-tri[i], -int(clust[i] * 1e6)))

    results: list[set[int]] = []
    for s in seeds:
        motif = _greedy_expand(s, neigh_idx, sets, cfg)
        if motif is None:
            continue
        if any(jaccard(motif, r) >= cfg.jaccard_dedup for r in results):
            continue
        results.append(motif)
        if len(results) >= cfg.max_sets:
            break
    return [sorted(r) for r in results]


def _adjacency(gl: GraphLaplacian) -> tuple[np.ndarray, torch.device]:
    W = gl.adjacency()
    return W.cpu().numpy().astype(np.float64), W.device


def spot_motives_eigen(gl: GraphLaplacian, cfg: MotiveConfig | None = None) -> list[list[int]]:
    """Motifs over the graph's own nodes, sorted node ids each."""
    cfg = cfg or MotiveConfig()
    W, dev = _adjacency(gl)
    return _spot(_neighbor_lists(W, cfg.top_l, by_weight=True), W.shape[0], cfg, dev)


def spot_motives_energy(gl_energy: GraphLaplacian, aspace: ArrowSpace,
                        cfg: MotiveConfig | None = None) -> list[list[int]]:
    """Motifs over the energy graph's nodes, mapped to the items whose
    ``centroid_map`` value is one of them; sorted item ids each."""
    cfg = cfg or MotiveConfig()
    W, dev = _adjacency(gl_energy)
    n_sc = W.shape[0]
    if n_sc == 0:
        return []
    sc_motifs = _spot(_neighbor_lists(W, cfg.top_l, by_weight=False), n_sc, cfg, dev)
    if aspace.centroid_map is None:
        return []
    cmap = np.asarray(aspace.centroid_map)
    out: list[list[int]] = []
    seen: list[set[int]] = []
    for motif in sc_motifs:
        items = set(np.nonzero(np.isin(cmap, motif))[0].tolist())
        if not items:
            continue
        if any(jaccard(items, s) >= cfg.jaccard_dedup for s in seen):
            continue
        seen.append(items)
        out.append(sorted(items))
    return out


def is_clique(gl: GraphLaplacian, nodes: set[int]) -> bool:
    """Every pair of ``nodes`` connected (at least two nodes)."""
    if len(nodes) < 2:
        return False
    W = gl.adjacency().cpu().numpy()
    lst = sorted(nodes)
    return all(W[a, b] > 1e-12 for a in lst for b in lst if a != b)


def rayleigh_indicator(gl: GraphLaplacian, nodes: set[int]) -> float:
    """``R_L(1_S)``, the cohesion of ``nodes`` (float64 on the host); inf
    for an empty set or a node out of range."""
    n = gl.shape[0]
    if n == 0 or not nodes or any(u >= n for u in nodes):
        return float("inf")
    x = np.zeros(n, np.float64)
    x[sorted(nodes)] = 1.0
    L = gl.dense().cpu().numpy().astype(np.float64)
    return float(x @ L @ x / (x @ x))
