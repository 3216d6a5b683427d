"""The benchmark's readers of the search entry's spans
(``portbench/metrics/entry.*.py``): each gives the median it names from a
hand-built span list, reads only the window's spans, gives nothing without
a ``search.batch`` root (an untraced run, or a program that records no
spans), and is listed for the three accepted cells, the streaming sketch's
cell, the JL cell and the JL energy cell after them, each of which reports
``search_qps``, the metric they move; ``entry.lambda_ms`` (the query λ's
span) for the JL cell, the exact cell, its point of comparison, and the
JL energy cell. ``scan.window_fill`` (``portbench/metrics/scan.window_fill.py``)
gives band pairs over dot pairs of the energy window route's tally, nothing
without a card, without the tally or at no dot pair, and is listed for the
two energy cells."""

import types

import pytest

from matternet_rs_tpu_torch.utils import profiling
from portbench.harness.manifest import ROOT, Manifest

CELLS = ["eigen-blobs1m.exact-b256", "energy-blobs1m.scan-b256", "eigen-blobs1m.bf16x3-b1024",
         "stream-centres10m.sketch-b1024", "eigen-jl1536-centres1m.exact1536-b256",
         "energy-jl1536-centres1m.scan1536-b256"]
METRICS = ["entry.host_ms", "entry.fetch_ms", "entry.syncs"]
READERS = METRICS + ["entry.lambda_ms"]
LAMBDA_CELLS = ["eigen-jl1536-centres1m.exact1536-b256", "eigen-blobs1m.exact-b256",
                "energy-jl1536-centres1m.scan1536-b256"]
FILL_CELLS = ["energy-jl1536-centres1m.scan1536-b256", "energy-blobs1m.scan-b256"]
MS = 1_000_000
OPENED_S = 10.0                         # the window opens at 10 s on perf_counter


def _call(next_id, t0_ms, root_ms, fetch_ms, syncs, thread=1):
    """One call's five spans, as the program records them: ``root_ms`` long
    from ``t0_ms``, the fetch ``fetch_ms`` at its end, ``syncs`` spread
    over the input and the fetch."""
    rid = next_id
    t0 = int(OPENED_S * 1e9) + t0_ms * MS
    t1 = t0 + int(root_ms * MS)
    part = (t1 - int(fetch_ms * MS) - t0) // 3
    kids = [("search.input", t0, t0 + part, syncs - syncs // 2),
            ("search.query_lambda", t0 + part, t0 + 2 * part, 0),
            ("search.scan", t0 + 2 * part, t1 - int(fetch_ms * MS), 0),
            ("search.fetch", t1 - int(fetch_ms * MS), t1, syncs // 2)]
    recs = [profiling.SpanRecord(n, rid + 1 + i, rid, rid, thread, s, e, c, {})
            for i, (n, s, e, c) in enumerate(kids)]
    return recs + [profiling.SpanRecord("search.batch", rid, None, rid, thread, t0, t1, 0,
                                        {"mode": "eigen", "tier": "exact", "b": 256,
                                         "b_pad": 256, "k": 10})]


def _read(name, recs, monkeypatch, opened=OPENED_S):
    monkeypatch.setattr(profiling, "spans", lambda: list(recs))
    ctx = {"window": types.SimpleNamespace(setup_end=opened)}
    return Manifest(ROOT).reader(name)(ctx)


# Three calls: (root ms, fetch ms, syncs) — medians 3.0 host, 2.5 fetch, 7 syncs; each
# query λ span a third of the call less its fetch, 1.0 ms.
CALLS = [(5.0, 2.0, 7), (6.0, 3.0, 9), (5.5, 2.5, 7)]
EXPECTED = {"entry.host_ms": 3.0, "entry.fetch_ms": 2.5, "entry.syncs": 7, "entry.lambda_ms": 1.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_the_median_it_names(monkeypatch, name):
    recs = []
    for i, (root_ms, fetch_ms, syncs) in enumerate(CALLS):
        recs += _call(1 + 10 * i, 10 * i, root_ms, fetch_ms, syncs)
    assert _read(name, recs, monkeypatch) == pytest.approx(EXPECTED[name], abs=1e-6)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_only_the_windows_spans(monkeypatch, name):
    before = _call(1, -5000, 50.0, 40.0, 30)          # a call 5 s before the window opened
    recs = list(before)
    for i, (root_ms, fetch_ms, syncs) in enumerate(CALLS):
        recs += _call(11 + 10 * i, 10 * i, root_ms, fetch_ms, syncs)
    assert _read(name, recs, monkeypatch) == pytest.approx(EXPECTED[name], abs=1e-6)


def test_sync_count_is_a_whole_number_per_call(monkeypatch):
    recs = _call(1, 0, 5.0, 2.0, 6) + _call(11, 10, 5.0, 2.0, 9)
    got = _read("entry.syncs", recs, monkeypatch)
    assert got == 6 and isinstance(got, int)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ["empty", "children_only", "other_spans"])
def test_reader_gives_nothing_without_a_root(monkeypatch, name, case):
    recs = {"empty": [],
            "children_only": [s for s in _call(1, 0, 5.0, 2.0, 7) if s.name != "search.batch"],
            "other_spans": [profiling.SpanRecord("x", 1, None, 1, 1, int(11e9), int(12e9), 3,
                                                 {})]}[case]
    assert _read(name, recs, monkeypatch) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_nothing_from_a_program_without_spans(monkeypatch, name):
    monkeypatch.delattr(profiling, "spans")
    ctx = {"window": types.SimpleNamespace(setup_end=OPENED_S)}
    assert Manifest(ROOT).reader(name)(ctx) is None


@pytest.mark.parametrize("name", METRICS)
def test_metric_is_listed_for_the_three_accepted_cells(name):
    man = Manifest(ROOT)
    (m,) = [m for m in man.data["per_layer"] if m["name"] == name]
    assert m["workloads"] == CELLS
    assert m["layer"] == "entry" and m["moves"] == "search_qps" and m["better"] == "lower"
    for cell in CELLS:
        man.workload(cell)
        assert "search_qps" in {x["name"] for x in man.metrics_of(cell, "end_to_end")}
        assert name in {x["name"] for x in man.metrics_of(cell, "per_layer")}


def test_lambda_metric_is_listed_for_the_jl_cell_and_the_exact_cell():
    man = Manifest(ROOT)
    (m,) = [m for m in man.data["per_layer"] if m["name"] == "entry.lambda_ms"]
    assert m["workloads"] == LAMBDA_CELLS and m["source"] == "program_span"
    assert m["layer"] == "entry" and m["moves"] == "search_qps" and m["better"] == "lower"
    for cell in LAMBDA_CELLS:
        assert "search_qps" in {x["name"] for x in man.metrics_of(cell, "end_to_end")}


def _fill(monkeypatch, tally, card=True):
    from matternet_rs_tpu_torch.ops.kernels import energy_scan

    monkeypatch.setattr("torch.cuda.is_available", lambda: card)
    monkeypatch.setattr(energy_scan, "window_tally", lambda device: dict(tally))
    return Manifest(ROOT).reader("scan.window_fill")({})


def test_window_fill_is_band_pairs_over_dot_pairs(monkeypatch):
    tally = {"band_pairs": 1_024_000, "dot_pairs": 40_960_000, "queries_past_band": 3,
             "rows_walked": 90}
    assert _fill(monkeypatch, tally) == pytest.approx(2.5, abs=1e-12)


@pytest.mark.parametrize("tally,card", [
    ({"band_pairs": 0, "dot_pairs": 0, "queries_past_band": 0, "rows_walked": 0}, True),
    ({"band_pairs": 5, "dot_pairs": 64, "queries_past_band": 0, "rows_walked": 0}, False),
], ids=["no_dot_pair", "no_card"])
def test_window_fill_gives_nothing_without_a_dot_pair_or_a_card(monkeypatch, tally, card):
    assert _fill(monkeypatch, tally, card) is None


def test_window_fill_gives_nothing_from_a_program_without_the_tally(monkeypatch):
    from matternet_rs_tpu_torch.ops.kernels import energy_scan

    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.delattr(energy_scan, "window_tally")
    assert Manifest(ROOT).reader("scan.window_fill")({}) is None


def test_window_fill_is_listed_for_the_two_energy_cells():
    man = Manifest(ROOT)
    (m,) = [m for m in man.data["per_layer"] if m["name"] == "scan.window_fill"]
    assert m["workloads"] == FILL_CELLS and m["source"] == "program_counter"
    assert m["layer"] == "kernels" and m["moves"] == "search_qps" and m["better"] == "higher"
    assert m["unit"] == "%"
    for cell in FILL_CELLS:
        assert "search_qps" in {x["name"] for x in man.metrics_of(cell, "end_to_end")}
