"""The JL-projected eigenmaps index on the card at 100,000 × 1536 rows of
the benchmark's ``centres256`` law (the cell
``eigen-jl1536-centres1m.exact1536-b256`` cut to 100,000 rows: 250
clusters, the λ space projected to 491 features): λ, the scan's
assignments, the projection and two 256-query batches of the exact tier
against the float64 reference (``portbench/reference/eigen_jl.py``) within
the cell's limits; and one traced call's span tree: ``search.project``
(attrs 1536 → 491) inside ``search.query_lambda``, whose route is
``closed`` (491 features are past the query kernel's 256), and every sync
the spans count is one that torch's sync debug mode warns of, in the same
span.

Every test needs a CUDA card and ``nvcc`` (marker ``gpu``) and skips
without them. This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_eigen_jl_gpu.py
"""

import collections
import gc
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from matternet_rs_tpu_torch import backend
from matternet_rs_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

N, B, POOL = 100_000, 256, 512
SEED = 2**31 + 23
CELL = "eigen-jl1536-centres1m.exact1536-b256"
SYNC_WARNING = "called a synchronizing CUDA operation"


@pytest.fixture(scope="module")
def run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if backend.nvcc_path() is None:
        pytest.skip("needs nvcc to build the kernels")
    from portbench.harness import gen
    from portbench.harness.manifest import ROOT, Manifest
    from portbench.harness.window import Window

    man = Manifest(ROOT)
    w = man.workload(CELL)
    cfg, traffic = man.config(w["config"]), man.traffic(w["traffic"])
    cfg["shape"]["n_items"] = N
    mode, law = man.module("modes", cfg["mode"]), man.module("corpora", cfg["corpus"]["law"])
    dev = torch.device("cuda")
    X = gen.corpus(cfg, law, SEED, dev)
    pool = gen.query_pool(cfg, law, POOL, SEED, dev)
    aspace, gl, _ = mode.build(cfg, X)
    k, alpha = int(traffic["k"]), float(traffic["alpha"])
    call = lambda Q: aspace.search_batch(Q, gl, k, alpha)   # noqa: E731
    answers = [(np.arange(q0, q0 + B), *call(pool[q0:q0 + B])) for q0 in range(0, POOL, B)]
    call(pool[:B])
    torch.cuda.synchronize()
    win = Window(seconds=1.0, attempted=POOL, completed=POOL, answers=answers, setup_end=0.0)
    return dict(cfg=cfg, traffic=traffic, mode=mode, X=X, pool=pool, aspace=aspace, gl=gl,
                call=call, win=win)


def test_the_build_and_search_hold_to_the_reference(run):
    from portbench.harness import check

    aspace = run["aspace"]
    assert aspace.n_clusters == 250 and aspace.reduced_dim == 491
    state = run["mode"].state(run["cfg"], aspace, run["gl"])
    ref = run["mode"].reference(run["cfg"], run["X"], state)
    readings, extra = run["mode"].judge(run["cfg"], run["traffic"], ref, state, run["pool"],
                                        run["win"])
    del ref
    ok, checks = check.verdict(readings, run["traffic"]["limits"])
    assert ok, checks
    assert extra["reduced_dim"] == 491 and extra["centroids"] == 250


def test_the_projection_is_a_span_inside_the_query_lambda(run):
    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            stack = getattr(profiling._open, "stack", None)
            seen.append(stack[-1].name if stack else "outside any span")

    Q = run["pool"][B:2 * B]
    profiling.clear_spans()
    gc.collect()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run["call"](Q)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    recs = profiling.spans()
    tree = {s.name: s for s in recs}
    assert [s.name for s in recs] == ["search.input", "search.project", "search.query_lambda",
                                      "search.scan", "search.fetch", "search.batch"]
    proj, qlam, root = tree["search.project"], tree["search.query_lambda"], tree["search.batch"]
    assert proj.parent == qlam.id and qlam.parent == root.id
    assert proj.attrs == {"f_in": 1536, "f_out": 491}
    assert qlam.attrs["route"] == "closed"
    warned = collections.Counter(seen)
    counted = collections.Counter({n: s.syncs for n, s in tree.items() if s.syncs})
    assert warned == counted, (warned, counted)
    # The queries' upload and the results' copy back, as at F = 128: the
    # projection and the closed form wait for nothing.
    assert sum(counted.values()) == 3 and counted["search.query_lambda"] == 0, counted
