"""The generators repeat by seed; the metric and work arithmetic."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.corpora import blobs5
from portbench.harness import gen, roofline, stats
from portbench.harness.pace import Pace
from portbench.reference.energy import EnergyIndex, token_budget
from portbench.work import energy_scan, exact_scan, rescored_scan


def test_corpus_and_queries_repeat_by_seed():
    cfg = {"shape": {"n_items": 1000, "n_features": 16}}
    big = 2**31 + 12345
    a, b = gen.corpus(cfg, blobs5, big, "cpu"), gen.corpus(cfg, blobs5, big, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, gen.corpus(cfg, blobs5, big + 1, "cpu"))
    qa, qb = gen.query_pool(cfg, blobs5, 64, big, "cpu"), gen.query_pool(cfg, blobs5, 64, big,
                                                                        "cpu")
    assert np.array_equal(qa, qb)
    # Held out: the queries come from another stream than the corpus.
    assert not np.isin(qa[:, 2], a[:, 2].numpy()).any()


def test_corpus_follows_the_fixture_law():
    x = gen.corpus({"shape": {"n_items": 5003, "n_features": 8}}, blobs5, 3, "cpu").numpy()
    per = 5003 // 5
    for c in range(5):
        rows = x[c * per:(c + 1) * per]
        assert np.allclose(rows[:, 0].mean(), 10.0 * c, atol=0.1)
        assert np.allclose(rows[:, 1].mean(), 10.0 * (c % 2), atol=0.1)
        assert np.abs(rows[:, 2:]).max() <= 0.8
    assert np.abs(x[5 * per:]).max() <= 1.0


def test_rate_is_over_the_whole_window():
    assert stats.rate(512, 2.0) == 256.0


def test_pace_counts_stalls_and_slices_the_window():
    p = Pace()
    p.start()
    p.laps = [0.01] * 98 + [0.5, 0.02]     # one stall of 0.5 s; 0.02 is under 3x
    p.last = p.t0 + sum(p.laps)
    s = p.summary()
    assert s["units"] == 100 and sum(s["units_by_tenth"]) == 100
    assert s["median_ms"] == pytest.approx(10.0)
    assert s["stalled_s"] == pytest.approx(0.5 - 0.03)
    assert s["max_ms"] == pytest.approx(500.0)
    # The stall fills 0.98-1.48 s of the 1.5 s window: its 8th and 9th tenths are empty.
    assert s["units_by_tenth"][7:] == [0, 0, 2]


def test_busy_union():
    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (10.0, 10.0)]
    assert stats.merge_spans(spans) == [[0.0, 3.0], [5.0, 6.0], [10.0, 10.0]]


def test_spread_uses_pythons_quartiles():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx((5.25 - 1.75) / 3.5)


def test_exact_scan_bound_is_three_bf16_passes():
    w = exact_scan.count(256, 1_000_000, 128, 10)
    assert roofline.least_seconds(w) == pytest.approx(3 * 2 * 256 * 1e6 * 128 / 989e12)
    assert roofline.least_seconds(w) == pytest.approx(0.199e-3, rel=0.01)
    r = rescored_scan.count(256, 1_000_000, 128, 10, 64, 128)
    assert r["tensor_flops"] - w["tensor_flops"] == 3 * 2 * 256 * 64 * 128 * 128
    assert r["bytes"] == w["bytes"]


def test_energy_scan_counts_only_the_tie_band():
    e = energy_scan.count(256, 1_000_000, 128, 10, tie_pairs=1000.0, tie_rows=300.0)
    assert e["tensor_flops"] == 3 * 2 * 1000 * 128
    assert e["cuda_flops"] == 3 * 256 * 1e6
    assert e["bytes"] == 8e6 + 4 * 300 * 128 + 4 * 256 * 128 + 12 * 256 * 10
    # The elementwise λ pass bounds it: 7.68e8 ops at 67 TFLOP/s.
    assert roofline.least_seconds(e) == pytest.approx(3 * 256e6 / 67e12)


def test_tie_band_count_from_the_reference():
    idx = object.__new__(EnergyIndex)
    idx.lambdas = torch.tensor([0.1, 0.1, 0.1, 0.5, 0.5, 0.9, 0.1 + 5e-10], dtype=torch.float64)
    idx.q_lams = torch.tensor([0.1, 0.5, 0.1, 0.7], dtype=torch.float64)
    pairs, rows = idx.tie_band(torch.zeros(4, 2), 0)
    # 0.1 → four items (one 5e-10 away), twice; 0.5 → two; 0.7 → none.
    assert pairs == 4 + 2 + 4 + 0
    assert rows == 6


def test_unit_work_by_traffic():
    cfg = {"shape": {"n_items": 1000, "n_features": 16}}
    mix = {"batch": 8, "k": 10}
    assert exact_scan.unit(mix, cfg, {}) == exact_scan.count(8, 1000, 16, 10)
    # Without the reference's tie band, the energy scan declares nothing.
    assert energy_scan.unit(mix, cfg, {}) is None
    assert energy_scan.unit(mix, cfg, {"tie_pairs": 5.0, "tie_rows": 2.0}) == energy_scan.count(
        8, 1000, 16, 10, 5.0, 2.0)


def test_token_budget_is_the_builds():
    assert token_budget(1_000_000) == 2000 and token_budget(16384) == 256
    assert token_budget(100) == 100


class _Ev:
    def __init__(self, name, dev, s_us, t_us, annotation=False):
        from torch.autograd import DeviceType

        self._n, self._s, self._t, self._a = name, s_us * 1000, t_us * 1000, annotation
        self._d = DeviceType.CUDA if dev else DeviceType.CPU

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def test_trace_reduction_busy_union_and_gap_labels():
    """Busy time is the union of device operations inside the window, the
    device-side copies of the host ranges are left out, and each idle gap
    takes the innermost host range over it (placed by the window's range)."""
    from types import SimpleNamespace

    from portbench.harness.trace import WINDOW, Tracer

    t = Tracer(False)
    t.on = True
    events = [_Ev(WINDOW, False, 1000, 2000), _Ev("pb.entry", True, 1000, 1900, True),
              _Ev("kernB", True, 1100, 1300), _Ev("kernC", True, 1250, 1400),
              _Ev("kernB", True, 1800, 2100)]
    t.prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: events)))
    # Host clock = trace time + 5e6 µs.
    t.ranges = [(6000 + 5e6, 7000 + 5e6, WINDOW), (6000 + 5e6, 6900 + 5e6, "pb.entry"),
                (6400 + 5e6, 6700 + 5e6, "pb.fetch")]
    out = t.reduce()
    assert out["window_s"] == pytest.approx(1e-3)
    assert out["busy_s"] == pytest.approx(500e-6)      # 1100–1400 and 1800–2000
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({"pb.entry": 100e-6, "pb.fetch": 400e-6})
    ops = dict(out["breakdown"]["device_ops"])
    assert ops == pytest.approx({"kernB": 400e-6, "kernC": 150e-6})


def test_ids_at_the_skip_score_are_not_judged():
    """An id the reference puts in a group merged with the query's (score
    ``skip_at``) counts in no reading; one outside the group does."""
    from portbench.harness.check import judge_answers

    S = torch.tensor([[0.1, 0.2, 1e6, 0.3, 1e9]], dtype=torch.float64)
    ans = lambda ids, sc: [(np.array([0]), np.array([ids]), np.array([sc], np.float64))]
    kw = dict(higher_is_better=False, score_below=1e9, skip_at=1e6)
    r = judge_answers(lambda a, b: S, 5, ans([0, 2, 1], [0.1, 0.15, 0.2]), 3, **kw)
    assert r["rank_gap"] == 0.0 and r["order_gap"] == 0.0 and r["score_err"] == 0.0
    r = judge_answers(lambda a, b: S, 5, ans([0, 4, 1], [0.1, 0.15, 0.2]), 3, **kw)
    assert r["rank_gap"] > 1e8
