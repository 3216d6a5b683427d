"""The ``energy_jl`` mode's reference and judge at small sizes on the CPU:
the reference with the identity for its projection is the unprojected
energy reference; the judge passes the program while failing the control
(the reference at TF32 in the program's place) and a program that kept no
projection; the control's state has the program's keys; a build that
makes no projection is refused; and the reference loads nothing of the
program or JAX."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import check, gen
from portbench.harness.manifest import ROOT, Manifest
from portbench.harness.window import Window
from portbench.reference.eigen import Precision
from portbench.reference.energy import EnergyIndex
from portbench.reference.energy_jl import EnergyJLIndex

CELL = "energy-jl1536-centres1m.scan1536-b256"
POOL, B = 128, 64


def _cfg(n, f, cap):
    man = Manifest(ROOT)
    w = man.workload(CELL)
    cfg, traffic = man.config(w["config"]), man.traffic(w["traffic"])
    cfg["shape"].update(n_items=n, n_features=f)
    cfg["builder"]["max_clusters"] = cap
    return man, cfg, traffic


@pytest.fixture(scope="module")
def small():
    """The cell at 2,000 × 256 with ``max_clusters`` 16 (r = 128): a build,
    a window of every pool query, the reference and the control."""
    from matternet_rs_tpu_torch import energymaps

    man, cfg, traffic = _cfg(2000, 256, 16)
    mode, law = man.module("modes", cfg["mode"]), man.module("corpora", cfg["corpus"]["law"])
    dev = torch.device("cpu")
    X = gen.corpus(cfg, law, 17, dev)
    pool = gen.query_pool(cfg, law, POOL, 17, dev)
    aspace, gl, _ = mode.build(cfg, X)
    k = int(traffic["k"])
    answers = [(np.arange(q0, q0 + B), *energymaps.search_energy_batch(aspace, pool[q0:q0 + B],
                                                                       gl, k))
               for q0 in range(0, POOL, B)]
    win = Window(seconds=1.0, attempted=POOL, completed=POOL, answers=answers, setup_end=0.0)
    state = mode.state(cfg, aspace, gl)
    ref = mode.reference(cfg, X, state)
    ctrl = mode.reference(cfg, X, None, "tf32")
    return dict(cfg=cfg, traffic=traffic, mode=mode, X=X, pool=pool, win=win, state=state,
                ref=ref, ctrl=ctrl)


def _failed(s, state, win):
    readings, extra = s["mode"].judge(s["cfg"], s["traffic"], s["ref"], state, s["pool"], win)
    return {n for n, c in check.verdict(readings, s["traffic"]["limits"])[1].items()
            if c["value"] > c["limit"]}, readings, extra


def test_the_program_passes(small):
    failed, readings, extra = _failed(small, small["state"], small["win"])
    assert failed == set(), readings
    assert extra["reduced_dim"] == 128 and extra["sub_centroids"] == 20


def test_the_control_fails(small):
    s, ctrl = small, small["ctrl"]
    cwin = Window(seconds=0.0, attempted=POOL, completed=POOL,
                  answers=s["mode"].answers(ctrl, s["traffic"], s["pool"]), setup_end=0.0)
    failed, readings, _ = _failed(s, s["mode"].reference_state(ctrl), cwin)
    assert {"projection_err", "subcentroid_err"} <= failed, readings


def test_a_program_without_its_projection_fails(small):
    state = dict(small["state"], projection=None)
    failed, readings, _ = _failed(small, state, small["win"])
    assert {"jl_dim_mismatch", "projection_err"} <= failed, readings


def test_the_controls_state_has_the_programs_keys(small):
    assert set(small["mode"].reference_state(small["ctrl"])) == set(small["state"]) - {"laplacian"}


def test_the_identity_projection_is_the_energy_reference(small):
    """Rows, queries and sub-centroids in the raw space: every λ, tie set
    and distance of ``EnergyIndex``."""
    X = small["X"][:, :128].contiguous()
    pool = torch.from_numpy(small["pool"][:, :128])
    S = small["ref"].C[:, :128]
    graph = small["cfg"]["graph"]
    plain = EnergyIndex(X, S, graph)
    ident = EnergyJLIndex(X, S, torch.eye(128, dtype=torch.float64), graph)
    assert torch.equal(plain.sc_lams, ident.sc_lams) and torch.equal(plain.lambdas, ident.lambdas)
    assert torch.equal(plain.near, ident.near) and torch.equal(plain.norms, ident.norms)
    plain.prepare_queries(pool, [])
    ident.prepare_queries(pool, [])
    assert torch.equal(plain.q_lams, ident.q_lams)
    assert torch.equal(plain.distances(pool[:B], 0), ident.distances(pool[:B], 0))


def test_a_build_without_a_projection_is_refused():
    """250 clusters of 256 features: the JL width 128 is not above them."""
    from portbench.reference.eigen_jl import replay

    man, cfg, _ = _cfg(600, 256, 250)
    mode, law = man.module("modes", cfg["mode"]), man.module("corpora", cfg["corpus"]["law"])
    X = gen.corpus(cfg, law, 5, torch.device("cpu"))
    assert len(replay(X, 250, 10_000.0, Precision("f64")).centroids) > 128
    with pytest.raises(ValueError, match="no projection"):
        mode.reference(cfg, X, None)


def test_the_reference_loads_nothing_of_the_program_or_jax():
    import json
    import subprocess
    import sys

    code = (f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import portbench.reference.energy_jl; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       timeout=300, check=True)
    names = set(json.loads(r.stdout.splitlines()[-1]))
    assert not names & {"matternet_rs_tpu_torch", "matternet_rs_tpu", "jax", "jaxlib", "flax"}
