"""The streaming sketch search's spans (``utils.profiling.span``) on the
CPU: nothing recorded and no ``record_function`` entered without a
profiler; under one, one ``search.batch`` tree a call (``mode="sketch"``,
the route taken, ``b``, ``k``, ``cand``), with exactly one
``search.fetch`` under the root and ``search.refine``'s ``rows`` the
candidate union's size; results bit for bit with spans on and off; and
the benchmark's readers of the entry and the refine each read a number
from a recorded window. The card's side (the sync count against torch's
sync debug mode, the spans on the profiler's clock) is
``test_torch_tracing_sketch_gpu.py``."""

import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.index.streaming import StreamingIndex
from matternet_rs_tpu_torch.storage import shards
from matternet_rs_tpu_torch.utils import profiling
from portbench.harness.manifest import ROOT, Manifest

N, F, BLK, B, K, CAND = 34_000, 32, 4_096, 24, 5, 20
REFINED = ("search.input", "search.query_lambda", "search.scan", "search.fetch",
           "refine.read", "refine.rescore", "search.refine", "search.batch")
UNREFINED = ("search.input", "search.query_lambda", "search.scan", "search.fetch",
             "search.batch")
# (route forced, refined)
CALLS = [("maxfirst", True), ("carry", True), ("maxfirst", False), ("carry", False)]
IDS = [f"{r}-{'refined' if f else 'sketch_only'}" for r, f in CALLS]
READERS = ["entry.host_ms", "entry.fetch_ms", "entry.syncs", "refine.read_ms",
           "refine.union_rows"]


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    """34,000 × 32 in 4,096-row blocks: nine blocks, 36,864 flat rows, 18
    tiles of 2,048, suffix-padded, so either route can be forced."""
    rng = np.random.default_rng(19)
    c = rng.normal(size=(8, F)) * 4.0
    data = (c[rng.integers(0, 8, N)] + rng.normal(size=(N, F))).astype(np.float32)
    d = tmp_path_factory.mktemp("store")
    shards.write_shards(data, d, rows_per_shard=8_192)
    idx = StreamingIndex.build_from_store(
        d, GraphParams(eps=1.0, k=6, topk=4, sparsity_check=False), max_clusters=16,
        radius=20.0, block_rows=BLK, sample_rows=4_096, emit_sketch=True, device="cpu")
    idx.build_sketch()
    Q = (data[rng.choice(N, B, replace=False)] + 0.01 * rng.normal(size=(B, F))).astype(np.float32)
    return idx, Q


def _call(index, route, refine):
    idx, Q = index
    idx.sketch_maxfirst = route == "maxfirst"
    return idx.search_batch_sketch(Q, K, 0.7, candidates=CAND, refine=refine)


def _traced(fn):
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, profiling.spans(), prof


@pytest.mark.parametrize("route,refine", CALLS, ids=IDS)
def test_no_profiler_records_nothing_and_enters_no_record_function(index, monkeypatch, route,
                                                                   refine):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_record_function", refuse)
    profiling.clear_spans()
    _call(index, route, refine)
    assert profiling.spans() == []


@pytest.mark.parametrize("route,refine", CALLS, ids=IDS)
def test_one_call_records_one_tree(index, route, refine):
    _, recs, prof = _traced(lambda: _call(index, route, refine))
    assert [s.name for s in recs] == list(REFINED if refine else UNREFINED)  # in the order they end
    root = recs[-1]
    assert root.parent is None and root.root == root.id
    assert root.attrs == {"mode": "sketch", "route": route, "b": B, "k": K, "cand": CAND}
    by_name = {s.name: s for s in recs}
    fetch = [s for s in recs if s.name == "search.fetch"]
    assert len(fetch) == 1 and fetch[0].parent == root.id
    for s in recs[:-1]:
        assert s.root == root.id and s.thread == root.thread
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        want = by_name["search.refine"].id if s.name.startswith("refine.") else root.id
        assert s.parent == want, s.name
    assert sum(s.syncs for s in recs) == 0          # the CPU has no host–device sync
    assert set(REFINED if refine else UNREFINED) <= {e.name for e in prof.events()}


@pytest.mark.parametrize("route", ["maxfirst", "carry"])
def test_refine_rows_is_the_candidate_unions_size(index, route):
    idx, Q = index
    idx.sketch_maxfirst = route == "maxfirst"
    Qt = idx._queries(Q)
    _, ids = idx._sketch_candidates(Qt, idx._query_lambdas(Qt), K, CAND, 0.7)  # the scan's [B, C]
    ids = ids.numpy()
    union = np.unique(ids[ids >= 0]).size
    _, recs, _ = _traced(lambda: _call(index, route, True))
    (ref,) = [s for s in recs if s.name == "search.refine"]
    assert ref.attrs == {"rows": union, "bytes": union * F * 4}
    assert K < union <= B * CAND


@pytest.mark.parametrize("route,refine", CALLS, ids=IDS)
def test_results_are_bit_identical_with_spans_on_and_off(index, route, refine):
    off = _call(index, route, refine)
    on, _, _ = _traced(lambda: _call(index, route, refine))
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_a_failed_call_still_closes_its_spans(index):
    idx, Q = index
    with pytest.raises(ValueError, match="doesn't match"):
        _traced(lambda: idx.search_batch_sketch(Q[:, :F - 1], K))
    assert [s.name for s in profiling.spans()] == ["search.input", "search.batch"]
    assert getattr(profiling._open, "stack", []) == []


@pytest.mark.parametrize("name", READERS)
def test_readers_read_a_recorded_window(index, name):
    """Three refined calls recorded after the window opened, one before."""
    _call(index, "maxfirst", True)
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        _call(index, "maxfirst", True)
        opened = time.perf_counter()
        for _ in range(3):
            _call(index, "maxfirst", True)
    ctx = {"window": types.SimpleNamespace(setup_end=opened)}
    got = Manifest(ROOT).reader(name)(ctx)
    assert got is not None and got >= 0
    window = [s for s in profiling.spans() if s.start_ns >= opened * 1e9]
    assert len([s for s in window if s.name == "search.batch"]) == 3
    if name == "refine.union_rows":
        rows = sorted(s.attrs["rows"] for s in window if s.name == "search.refine")
        assert got == rows[1]


@pytest.mark.parametrize("name", ["refine.read_ms", "refine.union_rows"])
def test_refine_readers_give_nothing_without_refine_spans(monkeypatch, name):
    other = profiling.SpanRecord("search.batch", 1, None, 1, 1, int(11e9), int(12e9), 0, {})
    monkeypatch.setattr(profiling, "spans", lambda: [other])
    ctx = {"window": types.SimpleNamespace(setup_end=10.0)}
    assert Manifest(ROOT).reader(name)(ctx) is None
    monkeypatch.delattr(profiling, "spans")
    assert Manifest(ROOT).reader(name)(ctx) is None


@pytest.mark.parametrize("name", ["refine.read_ms", "refine.union_rows"])
def test_refine_metric_is_listed_for_the_sketch_cell(name):
    man = Manifest(ROOT)
    (m,) = [m for m in man.data["per_layer"] if m["name"] == name]
    assert m["workloads"] == ["stream-centres10m.sketch-b1024"]
    assert m["layer"] == "refine" and m["moves"] == "search_qps"
    assert "search_qps" in {x["name"] for x in man.metrics_of(m["workloads"][0], "end_to_end")}


def test_the_refines_maps_are_kept_and_left_out_of_pickles(index):
    """The refine reads the store through one reader made at its first
    call; a pickle (a serving worker's copy) takes none, and the copy
    reads the same rows through maps of its own."""
    import pickle

    idx, _ = index
    _call(index, "carry", True)
    maps = idx._refine_maps
    assert maps is not None
    _call(index, "maxfirst", True)
    assert idx._refine_maps is maps
    twin = pickle.loads(pickle.dumps(idx))
    assert twin._refine_maps is None
    ids = np.array([7, 3, 33_999, 3, 4_096])
    assert np.array_equal(twin._store_maps()[0].rows(ids), maps[0].rows(ids))
    assert np.array_equal(maps[0].rows(ids), shards.read_rows(idx.directory, ids))
