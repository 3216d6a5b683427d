"""The JL-projected energymaps build and its full scan against the
benchmark's float64 reference (``portbench/reference/energy_jl.py``), on
the CPU at 2,000 × 384 rows of the cell's ``centres256`` law with
``max_clusters`` 12, so the JL width (192) exceeds the centroid count and
the build projects: the sub-centroids and their λ, every item's λ, the
scan's assignments, the projection and the searched ids and distances
each hold within the limits of the cell
``energy-jl1536-centres1m.scan1536-b256``. Five faults each fail: the
queries' λ taken without the projection, a projection drawn from another
seed, the projection's product at TF32, one item moved to its
second-nearest sub-centroid, and the cosine order of a band reversed.
Nothing here imports JAX."""

import numpy as np
import pytest
import torch

from portbench.harness import check, gen
from portbench.harness.manifest import ROOT, Manifest
from portbench.harness.window import Window

N, F, CAP, B, POOL = 2_000, 384, 12, 64, 128
SEED = 2**31 + 13
CELL = "energy-jl1536-centres1m.scan1536-b256"
DEV = torch.device("cpu")


def _cell():
    man = Manifest(ROOT)
    w = man.workload(CELL)
    cfg = man.config(w["config"])
    cfg["shape"].update(n_items=N, n_features=F)
    cfg["builder"]["max_clusters"] = CAP
    return man, cfg, man.traffic(w["traffic"]), man.module("modes", cfg["mode"])


def _window(aspace, gl, pool, traffic, alter=None):
    from matternet_rs_tpu_torch import energymaps

    answers = []
    for q0 in range(0, POOL, B):
        ids, d = energymaps.search_energy_batch(aspace, pool[q0:q0 + B], gl, int(traffic["k"]))
        if alter is not None:
            ids, d = alter(ids.copy(), d.copy())
        answers.append((np.arange(q0, q0 + B), ids, d))
    return Window(seconds=1.0, attempted=POOL, completed=POOL, answers=answers, setup_end=0.0)


@pytest.fixture(scope="module")
def run():
    """One sound build, its window, state and reference; the corpus and pool."""
    man, cfg, traffic, mode = _cell()
    law = man.module("corpora", cfg["corpus"]["law"])
    X = gen.corpus(cfg, law, SEED, DEV)
    pool = gen.query_pool(cfg, law, POOL, SEED, DEV)
    aspace, gl, _ = mode.build(cfg, X)
    win = _window(aspace, gl, pool, traffic)
    state = mode.state(cfg, aspace, gl)
    ref = mode.reference(cfg, X, state)
    return dict(cfg=cfg, traffic=traffic, mode=mode, X=X, pool=pool, aspace=aspace, gl=gl,
                win=win, state=state, ref=ref)


def _failed(run, state, win, ref=None):
    readings, _ = run["mode"].judge(run["cfg"], run["traffic"], ref or run["ref"], state,
                                    run["pool"], win)
    ok, checks = check.verdict(readings, run["traffic"]["limits"])
    return {n for n, c in checks.items() if c["value"] > c["limit"]}, readings


def _rebuilt(run, monkeypatch, module, name, wrap):
    """The build again with ``module.name`` wrapped, its state and window."""
    monkeypatch.setattr(module, name, wrap(getattr(module, name)))
    aspace, gl, _ = run["mode"].build(run["cfg"], run["X"])
    return run["mode"].state(run["cfg"], aspace, gl), _window(aspace, gl, run["pool"],
                                                              run["traffic"])


def test_the_build_projects_at_the_jl_width(run):
    from portbench.reference.eigen_jl import projected_dim

    aspace, gl = run["aspace"], run["gl"]
    assert aspace.n_clusters == CAP
    r = projected_dim(CAP, F, 0.3)
    assert r == 192 and aspace.reduced_dim == r and tuple(gl.dense().shape) == (r, r)
    assert tuple(run["state"]["projection"].shape) == (F, r)
    assert tuple(aspace.sub_centroids.shape) == (16, r)      # 2 of the 12 split


def test_the_program_holds_within_the_cells_limits(run):
    failed, readings = _failed(run, run["state"], run["win"])
    assert failed == set(), readings
    assert readings["assign_mismatch"] == 0 and readings["bad_ids"] == 0
    assert readings["recall"] == 1.0


def test_queries_lambda_without_the_projection_fails(run):
    """The batch's λ from its first r raw features, not from its projection."""
    aspace, r = run["aspace"], run["aspace"].reduced_dim
    real = aspace.projection

    class Unprojected:
        original_dim, reduced_dim, seed = real.original_dim, real.reduced_dim, real.seed

        def project(self, x, device=None):
            return x[..., :r].contiguous()

        def matrix(self, device=None):
            return real.matrix(device)

    aspace.projection = Unprojected()
    try:
        win = _window(aspace, run["gl"], run["pool"], run["traffic"])
    finally:
        aspace.projection = real
    failed, readings = _failed(run, run["state"], win)
    assert "tie_rank_gap" in failed, readings


def test_a_projection_from_another_seed_fails(run):
    """The build's own matrix is self-consistent, so only the draw from the
    configuration's seed tells it apart."""
    from matternet_rs_tpu_torch import ArrowSpaceBuilder

    cfg = run["cfg"]
    b = cfg["builder"]
    aspace, gl = (ArrowSpaceBuilder(device=DEV).with_lambda_graph(*b["lambda_graph"])
                  .with_sparsity_check(False).with_cluster_params(max_clusters=CAP,
                                                                  radius=b["radius"])
                  .with_sampling(None).with_expected_items(N).with_dims_reduction(True, 0.3)
                  .with_seed(7).build_energy(run["X"].numpy()))
    assert aspace.projection.seed == 7
    state = run["mode"].state(cfg, aspace, gl)
    ref = run["mode"].reference(cfg, run["X"], state)
    failed, readings = _failed(run, state, _window(aspace, gl, run["pool"], run["traffic"]), ref)
    assert failed == {"projection_err"}, readings


def test_the_projection_at_tf32_fails(run, monkeypatch):
    from matternet_rs_tpu_torch import reduction
    from matternet_rs_tpu_torch.ops.kernels.taumode import tf32_round

    def tf32(mm):
        return lambda a, b: torch.matmul(tf32_round(a.contiguous()), tf32_round(b.contiguous()))

    state, win = _rebuilt(run, monkeypatch, reduction, "mm", tf32)
    failed, readings = _failed(run, state, win)
    assert "subcentroid_err" in failed, readings


def test_an_item_moved_to_its_second_nearest_subcentroid_fails(run, monkeypatch):
    """The assignment's first row whose second-nearest sub-centroid (by L2
    over its projection) has another λ goes there."""
    from matternet_rs_tpu_torch import energymaps

    def second_nearest(assign):
        def f(Xc, sc, sc_sq, scn, sc_lam):
            out = assign(Xc, sc, sc_sq, scn, sc_lam).clone()
            if not f.done:
                order = torch.argsort(torch.cdist(Xc.double(), sc.double()), dim=1)
                r = int(torch.nonzero(sc_lam[order[:, 1]] != sc_lam[order[:, 0]])[0, 0])
                out[r], f.done = order[r, 1], True
            return out
        f.done = False
        return f

    state, win = _rebuilt(run, monkeypatch, energymaps, "_assign_chunk", second_nearest)
    failed, readings = _failed(run, state, win)
    assert "item_lambda_err" in failed, readings


def test_a_bands_cosine_order_reversed_fails(run):
    """Each answer's entries inside the tie band (|Δλ| < 1e-9, first in the
    ascending order) reversed, ids with their own distances."""
    from portbench.reference.energy import TIE_EPS

    def reverse_band(ids, d):
        for row in range(len(ids)):
            m = np.nonzero(d[row] < TIE_EPS)[0]
            ids[row, m], d[row, m] = ids[row, m[::-1]], d[row, m[::-1]]
        return ids, d

    win = _window(run["aspace"], run["gl"], run["pool"], run["traffic"], reverse_band)
    failed, readings = _failed(run, run["state"], win)
    assert "tie_rank_gap" in failed, readings
