"""The streaming sketch search's spans and sync counter on the card
(``utils.profiling.span``): one refined ``search_batch_sketch`` by each
route (B = 256 over a 1,000,000 × 96 store in 131,072-row blocks: eight
blocks, 1,048,576 flat rows).

(a) The spans run on the profiler's clock: shifted by one anchor (the
root's profiler event less the root's ``perf_counter_ns`` start), every
span's start and end lie within 50 µs of the profiler's own event for it,
and every device operation of the call starts inside the root.

(b) The sync counter is complete: with ``torch.cuda.set_sync_debug_mode
("warn")`` torch warns once for each synchronising call; those raised
inside each span equal the syncs that span counted, and none is raised
outside the spans.

Every test needs a CUDA card and ``nvcc`` (marker ``gpu``) and skips
without them. This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_tracing_sketch_gpu.py
"""

import collections
import gc
import warnings

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from matternet_rs_tpu_torch import backend
from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.index.streaming import StreamingIndex
from matternet_rs_tpu_torch.storage import shards
from matternet_rs_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

N, F, BLK, B, K = 1_000_000, 96, 131_072, 256, 10
CLOCK_TOL_NS = 50_000
SYNC_WARNING = "called a synchronizing CUDA operation"
ROUTES = ("maxfirst", "carry")
NAMES = {"search.batch", "search.input", "search.query_lambda", "search.scan", "search.fetch",
         "search.refine", "refine.read", "refine.rescore"}


@pytest.fixture(scope="module")
def calls(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if backend.nvcc_path() is None:
        pytest.skip("needs nvcc to build the kernels")
    rng = np.random.default_rng(11)
    c = rng.standard_normal((256, F), dtype=np.float32) * 4.0
    data = c[rng.integers(0, 256, N)] + rng.standard_normal((N, F), dtype=np.float32)
    d = tmp_path_factory.mktemp("store")
    shards.write_shards(data, d)
    idx = StreamingIndex.build_from_store(
        d, GraphParams(eps=1.0, k=6, topk=4, sparsity_check=False), max_clusters=128,
        radius=25.0, block_rows=BLK, emit_sketch=True)
    idx.build_sketch()
    Q = data[rng.choice(N, B, replace=False)] + 0.01 * rng.standard_normal((B, F), dtype=np.float32)

    def call(route):
        idx.sketch_maxfirst = route == "maxfirst"
        return idx.search_batch_sketch(Q, K, 0.7)

    for r in ROUTES:
        call(r)
    torch.cuda.synchronize()
    return call


def _tree(recs):
    roots = [s for s in recs if s.name == "search.batch"]
    assert len(roots) == 1, [s.name for s in recs]
    tree = {s.name: s for s in recs if s.root == roots[0].id}
    assert set(tree) == NAMES, sorted(tree)
    return roots[0], tree


@pytest.mark.parametrize("route", ROUTES)
def test_spans_share_the_profilers_clock(calls, route):
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        calls(route)
    root, tree = _tree(profiling.spans())
    assert root.attrs["route"] == route
    host, device = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name() in tree:
            assert e.name() not in host, f"two profiler events named {e.name()}"
            host[e.name()] = (e.start_ns(), e.end_ns())
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            device.append((e.start_ns(), e.name()))
    assert set(host) == set(tree)
    anchor = host["search.batch"][0] - root.start_ns
    for name, s in tree.items():
        e0, e1 = host[name]
        d0, d1 = s.start_ns + anchor - e0, s.end_ns + anchor - e1
        assert abs(d0) <= CLOCK_TOL_NS and abs(d1) <= CLOCK_TOL_NS, (name, d0, d1)
    r0, r1 = host["search.batch"]
    assert device
    late = [(n, (t - r0) / 1e3) for t, n in device if not r0 <= t <= r1]
    assert not late, late[:5]


@pytest.mark.parametrize("route", ROUTES)
def test_sync_count_matches_torchs_sync_debug_mode(calls, route):
    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            return
        stack = getattr(profiling._open, "stack", None)
        seen.append((stack[-1].name if stack else "outside any span", f"{filename}:{lineno}"))

    profiling.clear_spans()
    gc.collect()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        with profile(activities=[ProfilerActivity.CPU]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                calls(route)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    root, tree = _tree(profiling.spans())
    warned = collections.Counter(name for name, _ in seen)
    counted = collections.Counter({n: s.syncs for n, s in tree.items() if s.syncs})
    sites = collections.defaultdict(list)
    for name, site in seen:
        sites[name].append(site)
    wrong = {n: (warned[n], counted[n], sites[n]) for n in set(warned) | set(counted)
             if warned[n] != counted[n]}
    assert not wrong, wrong
    assert counted["search.fetch"] == 1
