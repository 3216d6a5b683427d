"""The ``eigen_jl`` mode's reference and judge at small sizes on the CPU:
the JL rule and the projection's draw against the program's, the windowed
clustering replay against the plain replay and the program's scan row for
row, the judge passing the program while failing the control (the
reference at TF32 in the program's place) and a program that kept no
projection, and the reference loading nothing of the program or JAX."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.corpora import blobs5, centres256
from portbench.harness import check, gen
from portbench.harness.manifest import ROOT, Manifest
from portbench.harness.window import Window
from portbench.reference import clustering
from portbench.reference.eigen import Precision
from portbench.reference.eigen_jl import jl_dim, jl_matrix, projected_dim, replay

CELL = "eigen-jl1536-centres1m.exact1536-b256"


@pytest.mark.parametrize("n", [2, 16, 250, 10_000, 10**6])
@pytest.mark.parametrize("f", [20, 96, 768, 1536, 3000, 20_000])
def test_jl_rule_is_the_programs(n, f):
    from matternet_rs_tpu_torch.reduction import compute_jl_dimension

    assert jl_dim(n, f, 0.3) == compute_jl_dimension(n, f, 0.3)
    r = min(compute_jl_dimension(n, f, 0.3), f // 2)
    assert projected_dim(n, f, 0.3) == (r if n < r < f else None)


@pytest.mark.parametrize("seed,f,r", [(42, 1536, 491), (7, 200, 100), (2**32 + 5, 64, 32)])
def test_the_draw_is_the_programs_matrix(seed, f, r):
    """Within the float32 draw's own rounding (its erfinv polynomial strays
    up to ≈ 6e-6 of an entry in the tails); another seed lies apart."""
    from matternet_rs_tpu_torch.reduction import projection_matrix_host

    drawn = jl_matrix(seed, f, r, "cpu")
    prog = torch.from_numpy(projection_matrix_host(seed, f, r)).double()
    assert drawn.dtype == torch.float64 and tuple(drawn.shape) == (f, r)
    assert float((prog - drawn).abs().max()) <= 1e-5 * float(drawn.abs().max())
    other = torch.from_numpy(projection_matrix_host(seed + 1, f, r)).double()
    assert float((other - drawn).abs().max()) > 0.5 * float(drawn.abs().max())


def _blobs(n, f, seed=3):
    g = torch.Generator()
    g.manual_seed(seed)
    return blobs5.rows(n, f, g, "cpu")


def _centres(n, f, seed=3):
    g = torch.Generator()
    g.manual_seed(seed)
    return centres256.rows(n, f, g, "cpu")


@pytest.mark.parametrize("rows,cap,radius", [
    (lambda: _blobs(3000, 32), 40, 6.0),          # mostly creates, then soft rows and drops
    (lambda: _blobs(3000, 32), 40, 200.0),        # a move with every row after the first
    (lambda: _blobs(3000, 32), 40, 25.0),         # moves, soft rows and drops mixed
    (lambda: _centres(4000, 256), 250, 2000.0),   # the cell's law: a cluster a centre, moves
    (lambda: _centres(4000, 256), 16, 2000.0),    # the cap reached early: the rest dropped
], ids=["blobs-r6", "blobs-r200", "blobs-r25", "centres-cap250", "centres-cap16"])
def test_windowed_replay_follows_the_plain_replay_and_the_scan(rows, cap, radius):
    from matternet_rs_tpu_torch.clustering import incremental_clustering

    X = rows()
    prog = incremental_clustering(X.numpy(), cap, radius)
    fast = replay(X, cap, radius, Precision("f64"), follow=prog.assignments)
    plain = clustering.replay(X, cap, radius, Precision("f64"), follow=prog.assignments)
    assert np.array_equal(fast.assignments, plain.assignments)
    assert np.array_equal(fast.counts, plain.counts) and fast.ambiguous == plain.ambiguous
    assert float((fast.centroids - plain.centroids).abs().max()) <= 1e-12 * float(
        plain.centroids.abs().max())
    r = clustering.readings(fast, prog.assignments, torch.from_numpy(prog.centroids))
    assert r["assign_mismatch"] == 0 and r["centroid_err"] <= 2 ** -24


@pytest.fixture(scope="module")
def small():
    """The cell at 2,000 × 256 with ``max_clusters`` 16 (r = 128): a build,
    a window of every pool query, the reference and the control."""
    man = Manifest(ROOT)
    w = man.workload(CELL)
    cfg, traffic = man.config(w["config"]), man.traffic(w["traffic"])
    cfg["shape"].update(n_items=2000, n_features=256)
    cfg["builder"]["max_clusters"] = 16
    mode, law = man.module("modes", cfg["mode"]), man.module("corpora", cfg["corpus"]["law"])
    dev = torch.device("cpu")
    X = gen.corpus(cfg, law, 17, dev)
    pool = gen.query_pool(cfg, law, 128, 17, dev)
    aspace, gl, _ = mode.build(cfg, X)
    k, alpha = int(traffic["k"]), float(traffic["alpha"])
    answers = [(np.arange(q0, q0 + 64), *aspace.search_batch(pool[q0:q0 + 64], gl, k, alpha))
               for q0 in range(0, 128, 64)]
    win = Window(seconds=1.0, attempted=128, completed=128, answers=answers, setup_end=0.0)
    state = mode.state(cfg, aspace, gl)
    ref = mode.reference(cfg, X, state)
    ctrl = mode.reference(cfg, X, None, "tf32")
    return dict(cfg=cfg, traffic=traffic, mode=mode, pool=pool, win=win, state=state, ref=ref,
                ctrl=ctrl)


def _failed(s, state, win):
    readings, extra = s["mode"].judge(s["cfg"], s["traffic"], s["ref"], state, s["pool"], win)
    return {n for n, c in check.verdict(readings, s["traffic"]["limits"])[1].items()
            if c["value"] > c["limit"]}, readings, extra


def test_the_program_passes(small):
    failed, readings, extra = _failed(small, small["state"], small["win"])
    assert failed == set(), readings
    assert extra["reduced_dim"] == 128 and extra["centroids"] == 16


def test_the_control_fails(small):
    s, ctrl = small, small["ctrl"]
    cwin = Window(seconds=0.0, attempted=128, completed=128,
                  answers=s["mode"].answers(ctrl, s["traffic"], s["pool"]), setup_end=0.0)
    failed, readings, _ = _failed(s, s["mode"].reference_state(ctrl), cwin)
    assert {"projection_err", "item_lambda_err"} <= failed, readings


def test_a_program_without_its_projection_fails(small):
    state = dict(small["state"], projection=None)
    failed, readings, _ = _failed(small, state, small["win"])
    assert {"jl_dim_mismatch", "projection_err"} <= failed, readings


def test_the_reference_loads_nothing_of_the_program_or_jax():
    import json
    import subprocess
    import sys

    code = (f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import portbench.reference.eigen_jl; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       timeout=300, check=True)
    names = set(json.loads(r.stdout.splitlines()[-1]))
    assert not names & {"matternet_rs_tpu_torch", "matternet_rs_tpu", "jax", "jaxlib", "flax"}
