"""The energymaps deployment at a width of 1536 on the card.

1. The window route (``csrc/energy_window.cu``) at F = 1536 on a
   many-band index: 200,000 rows of the benchmark's ``centres256`` law
   whose λ take 300 values (224 groups three times as large as the other
   76, as the cell's 250 clusters of which 26 split give them), and
   batches of 256 and 1,024 queries on random groups' λ, so that most
   bands hold one to three of a batch's queries. Ids and distances are
   ``energy_scan`` + G's merge's bit for bit at k 1, 10 and 16; the tally
   counts every band pair and is the plan's plain mirror's
   (``energy_scan.window_plan_plain``): at B = 256 every band holds at most
   the narrow width's queries and every dot pair lies on narrow tiles; at
   B = 1,024, every λ group a band of about three queries, the union of
   consecutive 64 queries' bands takes fewer tiles and the plan takes it,
   all 64-query tiles.
2. The cell ``energy-jl1536-centres1m.scan1536-b256`` cut to 100,000
   rows (250 clusters, the λ space projected to 491, ``build_energy``):
   two 256-query batches of ``search_energy_batch``'s full scan against
   the float64 reference (``portbench/reference/energy_jl.py``) within the
   cell's limits, every batch on the window route; and one traced call's
   span tree: ``search.project`` (attrs 1536 → 491) inside
   ``search.query_lambda``, ``route="window"`` on ``search.scan``, and the
   3 syncs the spans count (the queries' upload and the results' copy
   back) those that torch's sync debug mode warns of, in the same spans.

Every test needs a CUDA card and ``nvcc`` (marker ``gpu``) and skips
without them. This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_energy_jl_gpu.py
"""

import collections
import gc
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from matternet_rs_tpu_torch import backend
from matternet_rs_tpu_torch import energymaps as tem
from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops.kernels import energy_scan as esk
from matternet_rs_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

F = 1536
BANDS_N, BANDS_GROUPS = 200_000, 300
N, B, POOL = 100_000, 256, 512
SEED = 2**31 + 29
CELL = "energy-jl1536-centres1m.scan1536-b256"
SYNC_WARNING = "called a synchronizing CUDA operation"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if backend.nvcc_path() is None:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _rows(n, seed, dev):
    from portbench.corpora import centres256

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return centres256.rows(n, F, g, dev)


@pytest.fixture(scope="module")
def bands():
    """Rows of the law with λ on 300 groups, their norms and the sorted view."""
    dev = _card()
    rng = np.random.default_rng(SEED)
    levels = np.sort(rng.choice(1 << 20, BANDS_GROUPS, replace=False)).astype(np.float32) / 2**20
    weight = np.r_[np.full(224, 3.0), np.full(BANDS_GROUPS - 224, 1.0)]
    group = rng.choice(BANDS_GROUPS, BANDS_N, p=weight / weight.sum())
    X = _rows(BANDS_N, SEED, dev)
    lam = torch.from_numpy(levels[group]).to(dev)
    s_lam, s_idx = torch.sort(lam, stable=True)
    return X, torch.sqrt(torch.sum(X * X, dim=1)), lam, s_lam, s_idx, levels, rng


@pytest.mark.parametrize("b", [256, 1024])
def test_window_route_is_the_scan_over_many_small_bands(bands, b):
    X, norms, lam, s_lam, s_idx, levels, rng = bands
    dev = X.device
    Q = _rows(b, SEED + b, dev)
    ql = torch.from_numpy(levels[rng.choice(len(levels), b)]).to(dev)
    n_bands = len(torch.unique(ql))
    assert n_bands > b // 4
    band = int(sum(int((lam == v).sum()) for v in ql.tolist()))
    w = esk.narrow_width()
    want = esk.window_plan_plain(s_lam.cpu(), ql.cpu(), w)
    for k in (1, 10, 16):
        torch.cuda.synchronize()
        kernels.reset_launches()
        esk.reset_window_tally(dev)
        gi, gd = esk.energy_topk_window(X, norms, s_lam, s_idx, Q, ql, k)
        assert kernels.launch_counts()["energy_window"] == -(-b // 1024)
        tally = esk.window_tally(dev)
        wi, wd = esk.energy_topk(X, norms, lam, Q, ql, k)
        assert torch.equal(gi, wi)
        assert torch.equal(gd.contiguous().view(torch.int32), wd.contiguous().view(torch.int32))
        assert tally["band_pairs"] == band, tally
        assert {name: tally[name] for name in want} == want, (tally, want)
        if b == 256:
            assert max(collections.Counter(ql.tolist()).values()) <= w
            assert tally["narrow_dot_pairs"] == tally["dot_pairs"], tally
        else:
            assert tally["narrow_dot_pairs"] == 0, tally


@pytest.fixture(scope="module")
def cell():
    """The cell's configuration at 100,000 rows: the build, two batches'
    answers and a warm call."""
    dev = _card()
    from portbench.harness import gen
    from portbench.harness.manifest import ROOT, Manifest
    from portbench.harness.window import Window

    man = Manifest(ROOT)
    w = man.workload(CELL)
    cfg, traffic = man.config(w["config"]), man.traffic(w["traffic"])
    cfg["shape"]["n_items"] = N
    mode, law = man.module("modes", cfg["mode"]), man.module("corpora", cfg["corpus"]["law"])
    X = gen.corpus(cfg, law, SEED, dev)
    pool = gen.query_pool(cfg, law, POOL, SEED, dev)
    aspace, gl, _ = mode.build(cfg, X)
    call = man.module("entries", traffic["entry"]).make(aspace, gl, traffic)
    kernels.reset_launches()
    answers = [(np.arange(q0, q0 + B), *call(pool[q0:q0 + B])) for q0 in range(0, POOL, B)]
    launches = kernels.launch_counts()
    torch.cuda.synchronize()
    win = Window(seconds=1.0, attempted=POOL, completed=POOL, answers=answers, setup_end=0.0,
                 units=list(range(POOL // B)))
    return dict(cfg=cfg, traffic=traffic, mode=mode, X=X, pool=pool, aspace=aspace, gl=gl,
                call=call, win=win, launches=launches)


def test_the_build_and_search_hold_to_the_reference(cell):
    from portbench.harness import check

    aspace = cell["aspace"]
    assert aspace.n_clusters == 250 and aspace.reduced_dim == 491
    assert tuple(aspace.sub_centroids.shape) == (302, 491)
    assert cell["launches"]["energy_window"] == POOL // B
    assert cell["launches"]["energy_scan"] == 0
    state = cell["mode"].state(cell["cfg"], aspace, cell["gl"])
    ref = cell["mode"].reference(cell["cfg"], cell["X"], state)
    readings, extra = cell["mode"].judge(cell["cfg"], cell["traffic"], ref, state, cell["pool"],
                                         cell["win"])
    del ref
    ok, checks = check.verdict(readings, cell["traffic"]["limits"])
    assert ok, checks
    assert extra["reduced_dim"] == 491 and extra["sub_centroids"] == 302


def test_the_projection_is_a_span_inside_the_query_lambda(cell):
    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            stack = getattr(profiling._open, "stack", None)
            seen.append(stack[-1].name if stack else "outside any span")

    Q = cell["pool"][B:2 * B]
    profiling.clear_spans()
    gc.collect()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                tem.search_energy_batch(cell["aspace"], Q, cell["gl"], 10)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    recs = profiling.spans()
    tree = {s.name: s for s in recs}
    assert [s.name for s in recs] == ["search.input", "search.project", "search.query_lambda",
                                      "search.scan", "search.fetch", "search.batch"]
    proj, qlam, root = tree["search.project"], tree["search.query_lambda"], tree["search.batch"]
    assert proj.parent == qlam.id and qlam.parent == root.id
    assert proj.attrs == {"f_in": F, "f_out": 491}
    assert tree["search.scan"].attrs == {"route": "window"}
    warned = collections.Counter(seen)
    counted = collections.Counter({n: s.syncs for n, s in tree.items() if s.syncs})
    assert warned == counted, (warned, counted)
    assert sum(counted.values()) == 3 and counted["search.query_lambda"] == 0, counted
