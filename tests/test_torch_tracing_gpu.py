"""The search entry's spans and sync counter on the card
(``utils.profiling.span``): one ``search_batch`` on the exact tier, one on
``bf16x3_rescored`` (B = 256, 65,536 × 128) and one
``search_energy_batch``.

(a) The spans run on the profiler's clock: shifted by one anchor (the
root's profiler event less the root's ``perf_counter_ns``
start), every span's start and end lie within 50 µs of the profiler's own
event for it, and every device operation of the call starts inside the
root on the trace's timeline.

(b) The sync counter is complete: with ``torch.cuda.set_sync_debug_mode
("warn")`` torch warns once for each synchronising call ("called a
synchronizing CUDA operation"); those raised inside each span equal the
syncs that span counted, and none is raised outside the spans.

Every test needs a CUDA card and ``nvcc`` (marker ``gpu``) and skips
without them. This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_tracing_gpu.py
"""

import collections
import gc
import traceback
import warnings

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from matternet_rs_tpu_torch import backend
from matternet_rs_tpu_torch import energymaps as tem
from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder
from matternet_rs_tpu_torch.utils import profiling
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

pytestmark = pytest.mark.gpu

N, F, B, K = 65_536, 128, 256, 10
CLOCK_TOL_NS = 50_000
SYNC_WARNING = "called a synchronizing CUDA operation"     # torch's text, one per sync
PATHS = ("exact", "bf16x3_rescored", "energy")


@pytest.fixture(scope="module")
def calls():
    """One call per path, on a 65,536-row eigen index and its energy twin,
    each made once so that first-use copies stay out of the checks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if backend.nvcc_path() is None:
        pytest.skip("needs nvcc to build the kernels")
    data = make_energy_test_dataset(N, F, seed=43).astype(np.float32)
    rng = np.random.default_rng(5)
    Q = (data[rng.choice(N, B, replace=False)]
         + 0.01 * rng.standard_normal((B, F))).astype(np.float32)

    def builder():
        return (ArrowSpaceBuilder().with_lambda_graph(1.0, 6).with_sparsity_check(False)
                .with_cluster_params(max_clusters=64, radius=25.0).with_sampling(None))

    aspace, gl = builder().build(data)
    easpace, egl = builder().with_expected_items(N).with_dims_reduction(True).build_energy(data)
    out = {
        "exact": lambda: aspace.search_batch(Q, gl, K, 0.7),
        "bf16x3_rescored": lambda: aspace.search_batch(Q, gl, K, 0.7,
                                                       quantized="bf16x3_rescored"),
        "energy": lambda: tem.search_energy_batch(easpace, Q, egl, K),
    }
    for call in out.values():
        call()
    torch.cuda.synchronize()
    return out


def _tree(recs):
    """The one ``search.batch`` root of ``recs`` and its spans by name."""
    roots = [s for s in recs if s.name == "search.batch"]
    assert len(roots) == 1, [s.name for s in recs]
    tree = {s.name: s for s in recs if s.root == roots[0].id}
    assert len(tree) == 5, sorted(tree)
    return roots[0], tree


@pytest.mark.parametrize("path", PATHS)
def test_spans_share_the_profilers_clock(calls, path):
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        calls[path]()
    root, tree = _tree(profiling.spans())
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
        assert abs(d0) <= CLOCK_TOL_NS and abs(d1) <= CLOCK_TOL_NS, (
            f"{path}: span {name} off the profiler's event by {d0 / 1e3:.1f} µs at its "
            f"start and {d1 / 1e3:.1f} µs at its end")
    r0, r1 = host["search.batch"]
    assert device, "the trace holds no device operation"
    late = [(n, (t - r0) / 1e3) for t, n in device if not r0 <= t <= r1]
    assert not late, f"{path}: device operations starting outside the root (µs from its start): {late[:5]}"


@pytest.mark.parametrize("path", PATHS)
def test_sync_count_matches_torchs_sync_debug_mode(calls, path):
    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):        # e.g. the mode's own notice
            return
        stack = getattr(profiling._open, "stack", None)
        where = f"{filename}:{lineno}"
        if not stack:
            where += " from " + " <- ".join(
                f"{f.filename}:{f.lineno}" for f in reversed(traceback.extract_stack()[-8:-1]))
        seen.append((stack[-1].name if stack else "outside any span", where))

    profiling.clear_spans()
    gc.collect()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        with profile(activities=[ProfilerActivity.CPU]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                calls[path]()
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
    assert not wrong, (f"{path}: spans whose count differs from torch's warnings "
                       f"(warned, counted, sites): {wrong}")
    assert sum(counted.values()) >= 1
