"""The search entry's spans (``utils.profiling.span``) on the CPU: nothing
recorded and no ``record_function`` entered without a profiler; under one,
one ``search.batch`` tree a call with its four children in order and the
attributes it names, in the profiler's own events too; one tree a thread;
the ring's bound; the sync helpers; results bit for bit with spans on and
off. The card's side (the shared clock, the sync count against torch's
sync debug mode) is ``test_torch_tracing_gpu.py``."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from matternet_rs_tpu_torch import energymaps as tem
from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder
from matternet_rs_tpu_torch.utils import profiling
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

CHILDREN = ("search.input", "search.query_lambda", "search.scan", "search.fetch")
K = 5
# (index, call, tier the root names): each mode and the tiers that route
# differently through the entry.
PATHS = [
    ("eigen", "exact", "exact"),
    ("eigen", "bf16", "bf16"),
    ("eigen", "bf16x3_rescored", "bf16x3_rescored"),
    ("eigen", "auto", "int8"),
    ("eigen", "int8_auto", "int8_rescored"),
    ("energy", "search_batch", "exact"),
    ("energy", "scan", "scan"),
    ("energy", "banded", "banded"),
]
IDS = ["-".join(p[:2]) for p in PATHS]


def _builder(**kw):
    return (ArrowSpaceBuilder(device="cpu", **kw).with_lambda_graph(1.0, 5)
            .with_sparsity_check(False).with_cluster_params(max_clusters=40, radius=120.0)
            .with_seed(9))


@pytest.fixture(scope="module")
def indexes():
    data = make_energy_test_dataset(1200, 32, seed=7).astype(np.float32)
    aspace, gl = _builder().build(data)
    easpace, egl = _builder().with_dims_reduction(True).build_energy(
        data, tem.EnergyParams(optical_tokens=16, neighbor_k=5, candidate_m=8))
    rng = np.random.default_rng(3)
    Q = (data[rng.choice(len(data), 12, replace=False)]
         + 0.01 * rng.standard_normal((12, data.shape[1]))).astype(np.float32)
    return {"eigen": (aspace, gl), "energy": (easpace, egl), "Q": Q}


def _call(indexes, index, how):
    aspace, gl = indexes[index]
    Q = indexes["Q"]
    if how == "scan":
        return tem.search_energy_batch(aspace, Q, gl, K)
    if how == "banded":
        return tem.search_energy_batch(aspace, Q, gl, K, candidates=40)
    quantized = {"exact": False, "search_batch": False, "bf16": True}.get(how, how)
    return aspace.search_batch(Q, gl, K, 0.7, quantized=quantized)


def _traced(fn):
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, profiling.spans(), prof


@pytest.mark.parametrize("index,how,tier", PATHS, ids=IDS)
def test_no_profiler_records_nothing_and_enters_no_record_function(indexes, monkeypatch,
                                                                   index, how, tier):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_record_function", refuse)
    profiling.clear_spans()
    _call(indexes, index, how)
    assert profiling.spans() == []
    assert profiling.span("search.batch", k=1) is profiling._NO_SPAN


@pytest.mark.parametrize("index,how,tier", PATHS, ids=IDS)
def test_one_call_records_one_tree_in_order(indexes, index, how, tier):
    _, recs, prof = _traced(lambda: _call(indexes, index, how))
    assert [s.name for s in recs] == [*CHILDREN, "search.batch"]    # in the order they end
    root = recs[-1]
    assert root.parent is None and root.root == root.id
    b = len(indexes["Q"])
    assert root.attrs == {"mode": "eigen" if index == "eigen" else "energy", "tier": tier,
                          "b": b, "b_pad": 16, "k": K}
    prev_end = root.start_ns
    for s in recs[:-1]:
        assert s.parent == root.id and s.root == root.id and s.thread == root.thread
        assert prev_end <= s.start_ns <= s.end_ns <= root.end_ns
        prev_end = s.end_ns
    # The CPU has no host–device sync to count.
    assert sum(s.syncs for s in recs) == 0
    names = {e.name for e in prof.events()}
    assert {"search.batch", *CHILDREN} <= names


@pytest.mark.parametrize("index,how,tier", PATHS, ids=IDS)
def test_results_are_bit_identical_with_spans_on_and_off(indexes, index, how, tier):
    off = _call(indexes, index, how)
    on, recs, _ = _traced(lambda: _call(indexes, index, how))
    assert len(recs) == 5
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_a_projected_batch_records_its_projection_inside_the_query_lambda():
    """With a JL projection (F = 128 → r = 64) the queries' projection is
    the span ``search.project`` inside ``search.query_lambda``, with the two
    widths; the results equal those of an untraced call."""
    data = make_energy_test_dataset(600, 128, seed=5).astype(np.float32)
    aspace, gl = (_builder().with_cluster_params(max_clusters=8).with_dims_reduction(True)
                  .build(data))
    assert aspace.reduced_dim == 64
    Q = data[:12] + np.float32(0.01)
    off = aspace.search_batch(Q, gl, K)
    on, recs, prof = _traced(lambda: aspace.search_batch(Q, gl, K))
    assert all(np.array_equal(a, b) for a, b in zip(off, on))
    assert [s.name for s in recs] == ["search.input", "search.project", "search.query_lambda",
                                      "search.scan", "search.fetch", "search.batch"]
    proj, qlam = recs[1], recs[2]
    assert proj.parent == qlam.id and proj.root == recs[-1].id
    assert proj.attrs == {"f_in": 128, "f_out": 64}
    assert qlam.start_ns <= proj.start_ns <= proj.end_ns <= qlam.end_ns
    assert "search.project" in {e.name for e in prof.events()}


def test_raw_lambdas_come_back_inside_the_fetch(indexes):
    aspace, gl = indexes["eigen"]
    off = aspace.search_batch(indexes["Q"], gl, K, return_raw=True)
    on, recs, _ = _traced(lambda: aspace.search_batch(indexes["Q"], gl, K, return_raw=True))
    assert len(on) == 3 and all(np.array_equal(a, b) for a, b in zip(off, on))
    assert [s.name for s in recs] == [*CHILDREN, "search.batch"]


def test_a_failed_call_still_closes_its_spans(indexes):
    aspace, gl = indexes["eigen"]
    with pytest.raises(ValueError, match="unknown quantized tier"):
        _traced(lambda: aspace.search_batch(indexes["Q"], gl, K, quantized="int4"))
    recs = profiling.spans()
    assert [s.name for s in recs] == ["search.input", "search.batch"]
    assert getattr(profiling._open, "stack", []) == []


def test_two_threads_record_two_trees(indexes):
    aspace, gl = indexes["eigen"]
    Q = indexes["Q"]
    start = threading.Barrier(2, timeout=60)
    results, errors = {}, []

    def work(i):
        try:
            start.wait()
            results[threading.get_ident()] = aspace.search_batch(Q[i::2], gl, K)
        except Exception as e:  # noqa: BLE001 - reported by the assert below
            errors.append(e)

    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    recs = profiling.spans()
    roots = [s for s in recs if s.name == "search.batch"]
    assert len(roots) == 2
    assert {r.thread for r in roots} == set(results)
    for r in roots:
        tree = [s for s in recs if s.root == r.id]
        assert sorted(s.name for s in tree) == sorted([*CHILDREN, "search.batch"])
        assert all(s.thread == r.thread for s in tree)
        assert all(s.parent == r.id for s in tree if s is not r)


def test_the_ring_keeps_its_bound():
    profiling.clear_spans()
    extra = 10
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(profiling.SPAN_RING + extra):
            with profiling.span("x"):
                pass
    recs = profiling.spans()
    assert len(recs) == profiling.SPAN_RING
    ids = [s.id for s in recs]
    assert ids == sorted(ids) and ids[-1] - ids[0] == profiling.SPAN_RING - 1
    profiling.clear_spans()
    assert profiling.spans() == []


def test_the_sync_helpers_count_against_the_innermost_span():
    host = torch.arange(4.0)
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.clear_spans()
        profiling.count_sync("meta")                    # no open span: nowhere to count
        with profiling.span("outer"):
            profiling.count_sync("meta")
            with profiling.span("inner"):
                moved = profiling.to_device(host, "meta")          # host → a device: one
                profiling.to_device(moved, "meta")                 # already there: none
                profiling.count_sync("cpu")                        # the host: none
                assert torch.equal(profiling.to_host(host), host)  # a host tensor: none
                profiling.count_sync(torch.device("meta"))
    recs = {s.name: s for s in profiling.spans()}
    assert moved.device.type == "meta"
    assert recs["inner"].syncs == 2 and recs["outer"].syncs == 1
    assert recs["inner"].parent == recs["outer"].id


def test_the_sync_helpers_count_nothing_without_a_profiler():
    profiling.clear_spans()
    with profiling.span("outer"):
        profiling.count_sync("meta")
        assert profiling.to_device(torch.ones(2), "meta").device.type == "meta"
    assert profiling.spans() == []
