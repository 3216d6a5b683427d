"""Port vs reference: sparsification, motif spotting and subgraphs, on
graphs and indexes carried across with ``convert`` (the same matrices in
both packages), torch-CPU against JAX-CPU.

Tolerances: sparsified adjacencies, motifs, cliques, node and item lists,
parent maps and root items equal; the Rayleigh indicator (float64 on the
host in both) equal; subgraph Laplacians within 1e-6·max(|L_ij|, 1) (a
degree sums its row in another order) and their Rayleigh
quotients within 1e-5 relative (f32 sums in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu import motives as jmv
from matternet_rs_tpu import subgraphs as jsg
from matternet_rs_tpu.builder import ArrowSpaceBuilder as JBuilder
from matternet_rs_tpu.core import ArrowSpace as JArrowSpace
from matternet_rs_tpu.graph import GraphLaplacian as JGraphLaplacian
from matternet_rs_tpu.graph import GraphParams as JGraphParams
from matternet_rs_tpu.ops import laplacian as jlap
from matternet_rs_tpu.sparsification import SfGrassSparsifier as JSparsifier
from matternet_rs_tpu.utils.fixtures import (
    make_gaussian_cliques,
    make_gaussian_cliques_multi,
    make_gaussian_hd,
)

from matternet_rs_tpu_torch import convert
from matternet_rs_tpu_torch import motives as tmv
from matternet_rs_tpu_torch import subgraphs as tsg
from matternet_rs_tpu_torch.core import ArrowSpace as TArrowSpace
from matternet_rs_tpu_torch.sparsification import SfGrassSparsifier as TSparsifier

CPU = "cpu"
TOL_L = 1e-6


def _graph(jgl):
    """A reference GraphLaplacian as the port's, on the CPU."""
    return convert.graph_from_arrays(
        np.asarray(jgl.matrix), graph_params=dataclasses.asdict(jgl.graph_params),
        init_data=np.asarray(jgl.init_data), nnodes=jgl.nnodes, device=CPU)


def _clique_graph():
    """Two 4-cliques joined by one bridge edge, and a pendant node (the
    reference's test graph)."""
    n = 9
    W = np.zeros((n, n))
    for block in ([0, 1, 2, 3], [4, 5, 6, 7]):
        for a in block:
            for b in block:
                if a != b:
                    W[a, b] = 1.0
    W[3, 4] = W[4, 3] = 0.2
    W[8, 0] = W[0, 8] = 0.1
    L = np.diag(W.sum(1)) - W
    return JGraphLaplacian(matrix=jnp.asarray(L, jnp.float32), init_data=jnp.asarray(np.eye(n), jnp.float32),
                           nnodes=n, graph_params=JGraphParams(sparsity_check=False))


def _clique_dataset_graph(seed):
    data = make_gaussian_cliques(12, 0.4, 5, 10, seed=seed).astype(np.float32)
    return jlap.build_laplacian_matrix(data, JGraphParams(eps=0.5, k=8, topk=8, sparsity_check=False))


# ------------------------------------------------------------ sparsification


@pytest.mark.parametrize("n,ratio,seed", [(10, 0.5, 0), (30, 0.5, 0), (40, 0.3, 1), (25, 0.05, 2),
                                          (25, 1.7, 3)])
def test_sparsifier_matches(n, ratio, seed):
    rng = np.random.default_rng(seed)
    W = rng.random((n, n))
    W = (W + W.T) / 2
    W[W < 0.2] = 0.0
    np.fill_diagonal(W, 0.0)
    if n == 10:
        W[:] = 0.0
        W[0, 1] = W[1, 0] = 1.0          # average degree below 10: unchanged
    tsp, jsp = TSparsifier(ratio), JSparsifier(ratio)
    assert tsp.target_ratio == jsp.target_ratio
    assert np.array_equal(tsp.sparsify_adjacency(W), jsp.sparsify_adjacency(W))
    rows = [[(int(j), float(W[i, j])) for j in np.nonzero(W[i])[0]] for i in range(n)]
    assert tsp.sparsify_graph(rows, n) == jsp.sparsify_graph(rows, n)
    assert tsp.with_target_ratio(0.25).target_ratio == jsp.with_target_ratio(0.25).target_ratio


# ------------------------------------------------------------------- motives


@pytest.mark.parametrize("cfg", [
    dict(min_triangles=1, min_clust=0.3), dict(min_triangles=1, min_clust=0.1, max_sets=1),
    dict(), dict(top_l=3, min_triangles=1, min_clust=0.2),
])
@pytest.mark.parametrize("graph", ["cliques", "dataset-3", "dataset-8"])
def test_spot_motives_eigen_matches(graph, cfg):
    jgl = _clique_graph() if graph == "cliques" else _clique_dataset_graph(int(graph[-1]))
    got = tmv.spot_motives_eigen(_graph(jgl), tmv.MotiveConfig(**cfg))
    ref = jmv.spot_motives_eigen(jgl, jmv.MotiveConfig(**cfg))
    assert got == ref
    if graph != "dataset-8" and cfg.get("min_triangles") == 1 and cfg.get("max_sets") is None:
        assert got


@pytest.mark.parametrize("graph", ["cliques", "dataset-3"])
def test_triangle_stats_match(graph):
    jgl = _clique_graph() if graph == "cliques" else _clique_dataset_graph(3)
    W = np.asarray(jgl.adjacency(), np.float64)
    for by_weight in (True, False):
        for top_l in (3, 16):
            nt = tmv._neighbor_lists(W, top_l, by_weight)
            nj = jmv._neighbor_lists(W, top_l, by_weight)
            assert all(np.array_equal(a, b) for a, b in zip(nt, nj))
            tt, ct = tmv._triangle_stats(nt, W.shape[0], CPU)
            tj, cj = jmv._triangle_stats(nj, W.shape[0])
            assert np.array_equal(tt, tj) and np.array_equal(ct, cj)


@pytest.mark.parametrize("nodes", [{0, 1, 2, 3}, {0, 1, 4}, {0, 4, 5}, {4, 5, 6, 7}, {8}, set(),
                                   {0, 9}, {3, 4}])
def test_is_clique_and_rayleigh_match(nodes):
    jgl = _clique_graph()
    tgl = _graph(jgl)
    if max(nodes, default=0) >= 9 and len(nodes) > 1:      # out of range: both raise
        for mod, gl in ((tmv, tgl), (jmv, jgl)):
            with pytest.raises(IndexError):
                mod.is_clique(gl, nodes)
    else:
        assert tmv.is_clique(tgl, nodes) == jmv.is_clique(jgl, nodes)
    assert tmv.rayleigh_indicator(tgl, nodes) == jmv.rayleigh_indicator(jgl, nodes)


def test_jaccard_matches():
    for a, b in (({1, 2}, {2, 3}), (set(), set()), ({1}, {1})):
        assert tmv.jaccard(a, b) == jmv.jaccard(a, b)


# ----------------------------------------------------- energy motifs, subgraphs


@pytest.fixture(scope="module")
def energy_cliques():
    """The reference's energy build of the multi-clique fixture, and the
    same index carried into the port."""
    data = make_gaussian_cliques_multi(300, 0.3, 6, 24, seed=999).astype(np.float32)
    b = (JBuilder().with_seed(999).with_lambda_graph(1.0, 8).with_sparsity_check(False)
         .with_cluster_params(max_clusters=30, radius=30.0).with_dims_reduction(True)
         .with_sampling(None).with_expected_items(len(data)))
    ja, jg = b.build_energy(data)
    p = ja.projection
    ta, tg = convert.arrowspace_from_arrays(
        np.asarray(ja.data), np.asarray(ja.lambdas), np.asarray(jg.matrix),
        min_lambdas=ja.min_lambdas, max_lambdas=ja.max_lambdas, range_lambdas=ja.range_lambdas,
        graph_params=dataclasses.asdict(jg.graph_params), init_data=np.asarray(jg.init_data),
        nnodes=jg.nnodes,
        projection=None if p is None else (p.original_dim, p.reduced_dim, p.seed),
        sub_centroids=np.asarray(ja.sub_centroids),
        subcentroid_lambdas=np.asarray(ja.subcentroid_lambdas),
        centroid_map=np.asarray(ja.centroid_map), item_norms=np.asarray(ja.item_norms), device=CPU)
    return (ja, jg), (ta, tg)


MOTIF_CFGS = [
    dict(top_l=18, min_triangles=1, min_clust=0.15, max_motif_size=30, max_sets=60, jaccard_dedup=0.65),
    dict(),
    dict(top_l=8, min_triangles=2, min_clust=0.3, max_motif_size=8),
]


@pytest.mark.parametrize("cfg", MOTIF_CFGS)
def test_spot_motives_energy_matches(energy_cliques, cfg):
    (ja, jg), (ta, tg) = energy_cliques
    got = tmv.spot_motives_energy(tg, ta, tmv.MotiveConfig(**cfg))
    assert got == jmv.spot_motives_energy(jg, ja, jmv.MotiveConfig(**cfg))
    if cfg:
        assert got


def _same_subgraph(t, j):
    assert t.node_indices == j.node_indices and t.item_indices == j.item_indices
    tl, jl = t.laplacian, j.laplacian
    assert tl.nnodes == jl.nnodes and tl.energy == jl.energy
    assert np.array_equal(tl.init_data.numpy(), np.asarray(jl.init_data))
    ref = np.asarray(jl.matrix)
    np.testing.assert_array_less(np.abs(tl.matrix.numpy() - ref), TOL_L * np.maximum(np.abs(ref), 1.0))
    if j.rayleigh is None:
        assert t.rayleigh is None
    else:
        assert t.rayleigh == pytest.approx(j.rayleigh, rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("rayleigh_max", [None, 0.5, 1e-3])
@pytest.mark.parametrize("min_size", [3, 5])
def test_spot_subg_motives_matches(energy_cliques, rayleigh_max, min_size):
    (ja, jg), (ta, tg) = energy_cliques
    mc = MOTIF_CFGS[0]
    got = tsg.spot_subg_motives(tg, ta, tsg.SubgraphConfig(tmv.MotiveConfig(**mc), rayleigh_max, min_size))
    ref = jsg.spot_subg_motives(jg, ja, jsg.SubgraphConfig(jmv.MotiveConfig(**mc), rayleigh_max, min_size))
    assert len(got) == len(ref)
    for t, j in zip(got, ref):
        _same_subgraph(t, j)
    if rayleigh_max is None:
        assert got


def test_spot_subg_motives_without_a_map_uses_cluster_assignments(energy_cliques):
    (ja, jg), (ta, tg) = energy_cliques
    ja2, ta2 = JArrowSpace.from_items(np.asarray(ja.data)), TArrowSpace.from_items(ta.data.numpy(), device=CPU)
    with pytest.raises(ValueError, match="centroid_map or cluster_assignments"):
        tsg.spot_subg_motives(tg, ta2)
    ca = np.arange(ta.nitems) % 7 - 1                 # -1: a dropped outlier
    ja2.cluster_assignments, ta2.cluster_assignments = ca, ca
    cfg = MOTIF_CFGS[0]
    got = tsg.spot_subg_motives(tg, ta2, tsg.SubgraphConfig(tmv.MotiveConfig(**cfg)))
    ref = jsg.spot_subg_motives(jg, ja2, jsg.SubgraphConfig(jmv.MotiveConfig(**cfg)))
    assert [s.node_indices for s in got] == [s.node_indices for s in ref]


def test_subgraph_from_parent_and_rayleigh_match():
    data = make_gaussian_cliques(10, 0.4, 3, 10, seed=7).astype(np.float32)
    cents = data[np.random.default_rng(5).permutation(len(data))[:8]]
    jgl = jlap.build_laplacian_from_k_cluster(
        jnp.asarray(cents), JGraphParams(eps=1.0, k=5, topk=5, sparsity_check=False), n_items=len(data))
    tgl = _graph(jgl)
    for nodes in ([0, 2, 4, 5], [1, 3], list(range(8))):
        t, j = tsg.Subgraph.from_parent(tgl, nodes, n_items=30), jsg.Subgraph.from_parent(jgl, nodes, n_items=30)
        t.compute_rayleigh()
        j.compute_rayleigh()
        _same_subgraph(t, j)


# --------------------------------------------------------- centroid hierarchy


@pytest.fixture(scope="module")
def centroid_graph():
    """A reference eigen build (its feature graph and cluster assignments)
    and the port's copy."""
    data = make_gaussian_hd(60, 0.5).astype(np.float32)
    ja, jg = JBuilder().with_seed(7).with_lambda_graph(1.0, 6, 2.0, None).with_sparsity_check(False).build(data)
    ta = TArrowSpace.from_items(data, device=CPU)
    ta.cluster_assignments = np.asarray(ja.cluster_assignments)
    return (ja, jg), (ta, _graph(jg))


@pytest.mark.parametrize("params", [
    dict(), dict(k=3, min_centroids=2, max_depth=3), dict(k=2, min_centroids=2, max_depth=4, eps=0.7),
    dict(min_centroids=10_000, max_depth=3),
])
def test_centroid_hierarchy_matches(centroid_graph, params):
    (ja, jg), (ta, tg) = centroid_graph
    th = tsg.build_centroid_hierarchy(tg, ta, tsg.CentroidGraphParams(**params))
    jh = jsg.build_centroid_hierarchy(jg, ja, jsg.CentroidGraphParams(**params))
    assert th.count_subgraphs() == jh.count_subgraphs()
    assert [len(lvl) for lvl in th.levels] == [len(lvl) for lvl in jh.levels]
    for tl, jl in zip(th.levels, jh.levels):
        for tn, jn in zip(tl, jl):
            assert tn.parent_map == jn.parent_map and tn.root_indices == jn.root_indices
            assert len(tn.children) == len(jn.children)
            _same_subgraph(tn.graph, jn.graph)
    flat_t = tsg.spot_subg_centroids(tg, ta, tsg.CentroidGraphParams(**params))
    flat_j = jsg.spot_subg_centroids(jg, ja, jsg.CentroidGraphParams(**params))
    assert len(flat_t) == len(flat_j)
    for t, j in zip(flat_t, flat_j):
        _same_subgraph(t, j)


@pytest.mark.parametrize("n,k", [(0, 3), (5, 3), (12, 5), (7, 10)])
def test_recluster_centroids_matches(n, k):
    c = np.random.default_rng(n).normal(size=(n, 6)).astype(np.float32)
    (lt, mt), (lj, mj) = tsg.recluster_centroids(c, k), jsg.recluster_centroids(c, k)
    assert np.array_equal(lt, lj) and lt.dtype == lj.dtype
    assert np.array_equal(mt, mj) and mt.dtype == mj.dtype


def test_hierarchy_needs_a_map_or_assignments(centroid_graph):
    _, (ta, tg) = centroid_graph
    bare = TArrowSpace.from_items(ta.data.numpy(), device=CPU)
    with pytest.raises(ValueError, match="centroid_map or cluster_assignments"):
        tsg.build_centroid_hierarchy(tg, bare)
    assert torch.equal(tg.init_data, ta.data.new_tensor(np.asarray(centroid_graph[0][1].init_data)))
