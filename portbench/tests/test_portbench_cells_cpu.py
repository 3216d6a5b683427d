"""Whole runs of each cell on the CPU at a tiny size (the harness's look
for a card skipped): the result line's schema, the comparison passing the
sound program, failing the control and failing a timed path or a build
broken underneath."""

from __future__ import annotations

import dataclasses
import importlib
import subprocess
import sys

import numpy as np
import pytest

from portbench import control
from portbench.harness.cell import run_cell
from portbench.harness.manifest import Manifest
from portbench.tests.conftest import ROOT, TINY_N

CELLS = [w["name"] for w in Manifest(ROOT).data["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line_schema(tiny_root, workload, trace):
    out = run_cell(workload, 2**31 + 99, 0.4, bool(trace), "cpu", root=tiny_root)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    man = Manifest(tiny_root)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev) and set(out["breakdown"]) == {
            "device_ops", "idle_gaps"}
        # No device time on the CPU: readers of device shares find nothing.
        allowed = {m["name"] for m in man.metrics_of(workload, "per_layer")}
        assert set(out["metrics"]) <= allowed
    else:
        assert set(out["metrics"]) == {m["name"] for m in man.metrics_of(workload, "end_to_end")}
        for m in out["metrics"].values():
            assert m["value"] > 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    import json
    json.dumps(out, allow_nan=False)


def _altered(orig):
    """An answer altered where it is produced: one id of the first query."""
    def f(*a, **kw):
        out = orig(*a, **kw)
        idx = out[0].copy()
        idx[0, 0] = (idx[0, 0] + 1) % TINY_N
        return (idx, *out[1:])
    return f


def _half_left_out(orig):
    """Half of the batch left out: its second half answered with the first
    half's results."""
    def f(*a, **kw):
        out = orig(*a, **kw)
        idx, sc = out[0].copy(), out[1].copy()
        h = len(idx) // 2
        idx[h:2 * h], sc[h:2 * h] = idx[:h], sc[:h]
        return (idx, sc, *out[2:])
    return f


def _ranks_11_to_20(orig):
    """A selection fault: each query answered with the ids the program ranks
    11th to 20th, with their own exact scores, in order."""
    def f(Q, gl, k, *a, **kw):
        idx, sc = orig(Q, gl, 2 * k, *a, **kw)[:2]
        return idx[:, k:].copy(), sc[:, k:].copy()
    return f


def _patch(monkeypatch, workload, fault):
    from matternet_rs_tpu_torch import energymaps
    from matternet_rs_tpu_torch.core import ArrowSpace

    if workload.startswith("energy"):
        orig_e = energymaps.search_energy_batch
        monkeypatch.setattr(energymaps, "search_energy_batch", lambda aspace, *a, **kw: fault(
            lambda *b, **c: orig_e(aspace, *b, **c))(*a, **kw))
    else:
        orig = ArrowSpace.search_batch
        monkeypatch.setattr(ArrowSpace, "search_batch", lambda self, *a, **kw: fault(
            lambda *b, **c: orig(self, *b, **c))(*a, **kw))


@pytest.mark.parametrize("fault", [_altered, _half_left_out, _ranks_11_to_20])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, workload, fault):
    _patch(monkeypatch, workload, fault)
    out = run_cell(workload, 5, 0.3, False, "cpu", root=tiny_root)
    assert out["correct"] is False


def test_selection_fault_fails_the_quantised_tier_by_recall_alone(tiny_root, monkeypatch):
    """Ranks 11–20 with their exact scores pass every score and order check
    of the bf16x3 cell: its recall shortfall is what catches them."""
    _patch(monkeypatch, "eigen-blobs1m.bf16x3-b1024", _ranks_11_to_20)
    out = run_cell("eigen-blobs1m.bf16x3-b1024", 5, 0.3, False, "cpu", root=tiny_root)
    failed = {n for n, c in out["checks"].items() if c["value"] > c["limit"]}
    assert failed == {"recall_shortfall"}, out["checks"]


def _moved_centroid(orig):
    """The build's clustering with its last centroid moved by 1%."""
    def f(*a, **kw):
        out = orig(*a, **kw)
        out.centroids[-1] *= 1.01
        return out
    return f


def _one_diffusion_step_short(orig):
    return lambda centroids, l0, p: orig(centroids, l0, dataclasses.replace(p, steps=p.steps - 1))


def _split_tau_doubled(orig):
    return lambda centroids, l0, p: orig(centroids, l0,
                                         dataclasses.replace(p, split_tau=2 * p.split_tau))


@pytest.mark.parametrize("workload,target,fault", [
    ("eigen-blobs1m.exact-b256", "clustering.incremental_clustering", _moved_centroid),
    ("energy-blobs1m.scan-b256", "clustering.incremental_clustering", _moved_centroid),
    ("energy-blobs1m.scan-b256", "energymaps.diffuse_and_split_subcentroids",
     _one_diffusion_step_short),
    ("energy-blobs1m.scan-b256", "energymaps.diffuse_and_split_subcentroids",
     _split_tau_doubled),
])
def test_broken_build_is_not_correct(tiny_root, monkeypatch, workload, target, fault):
    """A build stage gone wrong: the reference, which works every stage out
    again from the corpus, comes out apart from the program."""
    mod_name, attr = target.split(".")
    mod = importlib.import_module(f"matternet_rs_tpu_torch.{mod_name}")
    monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))
    out = run_cell(workload, 5, 0.3, False, "cpu", root=tiny_root)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(tiny_root, workload):
    """The reference at TF32 in the program's place fails a limit on every
    seed; the program passes them."""
    man = Manifest(tiny_root)
    limits = man.traffic(man.workload(workload)["traffic"])["limits"]
    for seed in (21, 22, 23):
        rec, = control.one_seed(man, [workload], seed, 0.3, "cpu")
        assert all(rec["program"][k] <= v for k, v in limits.items()), rec["program"]
        assert any(rec["control"][k] > v for k, v in limits.items()), rec["control"]


def test_run_without_a_card_prints_no_result(tmp_path):
    r = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode != 0
    assert not any(line.startswith('{"correct"') for line in r.stdout.splitlines())


def test_alone_without_the_program_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/ it fails."""
    from portbench.tests.conftest import copy_bench

    root = copy_bench(tmp_path, None)
    r = subprocess.run([sys.executable, str(root / "portbench" / "run.py"), "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=root, timeout=120)
    assert r.returncode != 0
    assert not any(line.startswith('{"correct"') for line in r.stdout.splitlines())


def test_answers_are_judged_once_each_and_counted_as_often():
    from portbench.harness.check import distinct_answers

    a = (np.arange(2), np.array([[1, 2], [3, 4]]), np.array([[0.5, 0.4], [0.3, 0.2]]))
    q, ids, sc, counts = distinct_answers([a, a, (np.array([0]), np.array([[1, 2]]),
                                                  np.array([[0.5, 0.41]]))], 2)
    assert len(q) == 3 and sorted(counts.tolist()) == [1, 2, 2]


def test_answers_that_share_a_hash_stay_apart(monkeypatch):
    """With every multiplier 1 the hash is a row's sum, so ids [1, 2] and
    [2, 1] of one query collide: the sort of whole rows keeps them apart."""
    from portbench.harness import check

    class Ones:
        def integers(self, lo, hi, n, dtype):
            return np.zeros(n, dtype)

    monkeypatch.setattr(check.np.random, "default_rng", lambda seed: Ones())
    a = (np.arange(1), np.array([[1, 2]]), np.array([[0.5, 0.5]]))
    b = (np.arange(1), np.array([[2, 1]]), np.array([[0.5, 0.5]]))
    q, ids, sc, counts = check.distinct_answers([a, b, a], 2)
    assert ids.tolist() == [[1, 2], [2, 1]] and counts.tolist() == [2, 1]

