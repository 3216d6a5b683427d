"""The JL-projected eigenmaps build and its search against the benchmark's
float64 reference (``portbench/reference/eigen_jl.py``), on the CPU at
3,000 × 1536 rows of the cell's ``centres256`` law with ``max_clusters``
16, so the JL width (247) exceeds the centroid count and the build
projects: λ, the scan's assignments, the projection and the searched ids
and scores each hold within the limits of the cell
``eigen-jl1536-centres1m.exact1536-b256``. Four faults each fail one: the
queries' λ taken without the projection, a projection drawn from another
seed, the projection's product at TF32, and an altered id. The
reference's windowed clustering replay follows the plain replay row for
row. Nothing here imports JAX."""

import numpy as np
import pytest
import torch

from portbench.harness import check, gen
from portbench.harness.manifest import ROOT, Manifest
from portbench.harness.window import Window

N, CAP, B, POOL = 3_000, 16, 64, 128
SEED = 2**31 + 11
CELL = "eigen-jl1536-centres1m.exact1536-b256"
DEV = torch.device("cpu")


def _cell():
    man = Manifest(ROOT)
    w = man.workload(CELL)
    cfg = man.config(w["config"])
    cfg["shape"]["n_items"] = N
    cfg["builder"]["max_clusters"] = CAP
    return man, cfg, man.traffic(w["traffic"]), man.module("modes", cfg["mode"])


def _window(aspace, gl, pool, traffic, alter=None):
    k, alpha = int(traffic["k"]), float(traffic["alpha"])
    answers = []
    for q0 in range(0, POOL, B):
        ids, sc = aspace.search_batch(pool[q0:q0 + B], gl, k, alpha)
        if alter is not None:
            ids = alter(ids.copy())
        answers.append((np.arange(q0, q0 + B), ids, sc))
    return Window(seconds=1.0, attempted=POOL, completed=POOL, answers=answers, setup_end=0.0)


def _tf32_mm(a, b):
    """A float32 product whose operands are rounded to TF32 first."""
    from matternet_rs_tpu_torch.ops.kernels.taumode import tf32_round

    return torch.matmul(tf32_round(a.contiguous()), tf32_round(b.contiguous()))


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
                win=win, state=state, ref=ref, law=law)


def _failed(run, state, win, ref=None):
    readings, _ = run["mode"].judge(run["cfg"], run["traffic"], ref or run["ref"], state,
                                    run["pool"], win)
    ok, checks = check.verdict(readings, run["traffic"]["limits"])
    return {n for n, c in checks.items() if c["value"] > c["limit"]}, readings


def test_the_build_projects_at_the_jl_width(run):
    from portbench.reference.eigen_jl import projected_dim

    aspace, gl = run["aspace"], run["gl"]
    assert aspace.n_clusters == CAP
    r = projected_dim(CAP, 1536, 0.3)
    assert r == 247 and aspace.reduced_dim == r and tuple(gl.dense().shape) == (r, r)
    assert tuple(run["state"]["projection"].shape) == (1536, r)


def test_the_program_holds_within_the_cells_limits(run):
    failed, readings = _failed(run, run["state"], run["win"])
    assert failed == set(), readings
    assert readings["assign_mismatch"] == 0 and readings["bad_ids"] == 0
    assert readings["recall"] == 1.0


def test_queries_lambda_without_the_projection_fails(run):
    """The batch's λ of its first r raw features, not of its projection."""
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
    assert {"score_err", "rank_gap"} <= failed, readings


def test_a_projection_from_another_seed_fails(run):
    """The build's own matrix is self-consistent, so only the draw from the
    configuration's seed tells it apart."""
    from matternet_rs_tpu_torch import ArrowSpaceBuilder

    cfg = run["cfg"]
    b = cfg["builder"]
    aspace, gl = (ArrowSpaceBuilder(device=DEV).with_lambda_graph(*b["lambda_graph"])
                  .with_sparsity_check(False).with_cluster_params(max_clusters=CAP,
                                                                  radius=b["radius"])
                  .with_sampling(None).with_dims_reduction(True, 0.3).with_seed(7)
                  .build(run["X"].numpy(), device_rows=run["X"]))
    assert aspace.projection.seed == 7
    state = run["mode"].state(cfg, aspace, gl)
    ref = run["mode"].reference(cfg, run["X"], state)
    failed, readings = _failed(run, state, _window(aspace, gl, run["pool"], run["traffic"]), ref)
    assert failed == {"projection_err"}, readings


def test_the_projection_at_tf32_fails(run, monkeypatch):
    from matternet_rs_tpu_torch import reduction

    monkeypatch.setattr(reduction, "mm", _tf32_mm)
    aspace, gl, _ = run["mode"].build(run["cfg"], run["X"])
    win = _window(aspace, gl, run["pool"], run["traffic"])
    failed, readings = _failed(run, run["mode"].state(run["cfg"], aspace, gl), win)
    assert "item_lambda_err" in failed, readings


def test_an_altered_id_fails(run):
    def alter(ids):
        ids[0, 0] = (ids[0, 0] + 1) % N
        return ids

    win = _window(run["aspace"], run["gl"], run["pool"], run["traffic"], alter)
    failed, readings = _failed(run, run["state"], win)
    assert failed & {"score_err", "rank_gap"}, readings


def test_the_windowed_replay_follows_the_plain_replay(run):
    """Row for row, with the same centroids and counts, over the cell's law:
    the windows here hold moves, which the plain replay takes one by one."""
    from portbench.reference import clustering
    from portbench.reference.eigen import Precision
    from portbench.reference.eigen_jl import replay

    X = run["X"][:1500]
    fast = replay(X, CAP, 10_000.0, Precision("f64"))
    plain = clustering.replay(X, CAP, 10_000.0, Precision("f64"))
    assert np.array_equal(fast.assignments, plain.assignments)
    assert np.array_equal(fast.counts, plain.counts)
    assert float((fast.centroids - plain.centroids).abs().max()) <= 1e-12
