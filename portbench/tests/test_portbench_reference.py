"""The reference's replay of the build against the program's own stages at
small sizes: the clustering scan row for row, the energy build's
compression, diffusion and split."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.corpora import blobs5
from portbench.reference import clustering
from portbench.reference.eigen import Precision
from portbench.reference.energy import sub_centroids


def _rows(n, f=32, seed=3):
    g = torch.Generator()
    g.manual_seed(seed)
    return blobs5.rows(n, f, g, "cpu")


@pytest.mark.parametrize("radius", [6.0, 200.0])
def test_replay_follows_the_scan_row_for_row(radius):
    """Radius 6 opens a centroid for most rows; radius 200 moves one with
    every row after the first."""
    from matternet_rs_tpu_torch.clustering import incremental_clustering

    X = _rows(3000)
    prog = incremental_clustering(X.numpy(), 40, radius)
    rep = clustering.replay(X, 40, radius, Precision("f64"), follow=prog.assignments)
    r = clustering.readings(rep, prog.assignments, torch.from_numpy(prog.centroids))
    assert r["assign_mismatch"] == 0
    assert r["centroid_err"] <= 2 ** -24          # the program's centroids, rounded to float32
    assert np.array_equal(rep.counts, prog.sizes)


def test_an_equidistant_row_takes_the_programs_choice():
    """Two centroids at ±1 on the first axis and a row at the origin: either
    is right; with ``follow`` the replay takes the one the program took."""
    X = torch.zeros((3, 4))
    X[0, 0], X[1, 0] = 1.0, -1.0
    for pick in (0, 1):
        follow = np.array([0, 1, pick])
        rep = clustering.replay(X, 2, 3.0, Precision("f64"), follow=follow)
        assert rep.ambiguous == 1 and rep.assignments[2] == pick
    # Without it, the first of the equal centroids, as the scan's strict "<".
    assert clustering.replay(X, 2, 3.0, Precision("f64")).assignments[2] == 0


def test_replay_counts_a_different_centroid_count_as_every_row():
    X = _rows(500)
    rep = clustering.replay(X, 10, 6.0, Precision("f64"))
    r = clustering.readings(rep, rep.assignments[:-1], rep.centroids[:-1])
    assert r["assign_mismatch"] == 500 and r["centroid_err"] == float("inf")


def test_energy_build_stages_match_the_programs():
    """Diffusion and split from the same centroids, against the program's."""
    from matternet_rs_tpu_torch import ArrowSpaceBuilder, energymaps

    C = _rows(250, 128, seed=5)[:60].numpy()
    b = ArrowSpaceBuilder(device="cpu").with_lambda_graph(1.0, 6).with_dims_reduction(True)
    b.nitems = 16384
    p = energymaps.EnergyParams.from_builder(b)
    l0 = energymaps.bootstrap_centroid_laplacian(C, b)
    prog = energymaps.diffuse_and_split_subcentroids(C, l0, p)
    graph = {"eps": 1.0, "p": 2.0, "sigma": 1.0, "topk": 3}
    energy = {"eta": p.eta, "steps": p.steps, "split_quantile": p.split_quantile,
              "neighbor_k": p.neighbor_k, "split_tau": p.split_tau}
    ref, margins = sub_centroids(torch.from_numpy(C), graph, energy, 16384, Precision("f64"))
    assert ref.shape == prog.shape
    err = float((torch.from_numpy(prog).double() - ref).abs().max() / ref.abs().max())
    assert err < 1e-6 and margins["split_gap"] > 0
    # A budget below the centroid count (100 at 400 items) would pool them:
    # the reference refuses.
    with pytest.raises(NotImplementedError):
        sub_centroids(_rows(250, 128, seed=5)[:150], graph, energy, 400, Precision("f64"))


def test_split_choices_within_rounding_take_the_programs():
    """A split row whose k-th and (k+1)-th nearest rows tie: either pair is
    right, and the reference takes the one nearer the program's."""
    from portbench.reference import energy as ref_energy

    work = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [-3.0, 0.0]], dtype=torch.float64)
    p0, p1, amb, gap = ref_energy._pairs(work, torch.tensor([0]), 1, 0.15, Precision("f64"))
    assert bool(amb[0]) and float(gap[0]) == 0.0 and not torch.equal(p0, p1)
    assert torch.equal(ref_energy._nearer(p0, p1, p1 + 1e-9), p1)
    assert torch.equal(ref_energy._nearer(p0, p1, p0), p0)


def test_sub_centroids_follow_the_program_only_where_choices_tie(monkeypatch):
    from portbench.reference import energy as ref_energy

    C = _rows(250, 128, seed=5)[:60]
    graph = {"eps": 1.0, "p": 2.0, "sigma": 1.0, "topk": 3}
    energy = {"eta": 0.1, "steps": 4, "split_quantile": 0.9, "neighbor_k": 15, "split_tau": 0.15}
    S, m = sub_centroids(C, graph, energy, 16384, Precision("f64"))
    assert m["split_ties"] == 0 and m["neighbour_ties"] == 0
    # A program far from both choices changes nothing where nothing ties.
    S2, _ = sub_centroids(C, graph, energy, 16384, Precision("f64"), follow=S + 1.0)
    assert torch.equal(S, S2)
    # Where every choice counts as tied, the program's own choice is kept.
    monkeypatch.setattr(ref_energy, "TOL", 1.0)
    S3, m3 = sub_centroids(C, graph, energy, 16384, Precision("f64"), follow=S)
    assert m3["split_ties"] == 1 and m3["neighbour_ties"] > 0 and torch.equal(S3, S)


def test_graph_neighbours_within_rounding_take_the_programs():
    """Feature 0 lies as near features 1 and 2: the graph keeps the lower
    index unless the program's Laplacian holds the other edge alone."""
    from portbench.reference.eigen import feature_laplacian, followed_laplacian, kth_ties

    nodes = torch.tensor([[1.0, 0.0, 0.0], [1.0, 1.0, 0.0], [1.0, 0.0, 1.0], [0.2, 1.0, 0.0],
                          [0.2, 0.0, 1.0]], dtype=torch.float64)
    graph = {"eps": 1.0, "p": 2.0, "sigma": 1.0}
    prec = Precision("f64")
    rows, kth, nxt, gap = kth_ties(nodes, 1, prec)
    assert 0 in rows.tolist() and gap == 0.0
    plain = feature_laplacian(nodes, 1.0, 2.0, 1.0, 1, prec)
    other = feature_laplacian(nodes, 1.0, 2.0, 1.0, 1, prec, swap_rows=torch.tensor([0]))
    assert not torch.equal(plain, other)
    assert torch.equal(followed_laplacian(nodes, graph, 1, prec, other)[0], other)
    assert torch.equal(followed_laplacian(nodes, graph, 1, prec, plain)[0], plain)
    assert torch.equal(followed_laplacian(nodes, graph, 1, prec)[0], plain)
