"""The streaming index with its resident int8 sketch against the
benchmark's float64 reference (``portbench/reference/streaming.py``), on
the CPU at 40,000 × 96 in 4,096-row blocks (ten blocks, 40,960 flat rows:
twenty 2,048-row tiles, so the maxima-first scan can be forced): the
stream mode's build from a store, the sketch's upload, refined searches
by both routes. λ, the sample's clustering, the sketch's codes and
multipliers and the refined ids and scores each hold within the cell's
limits (``portbench/traffic/sketch-b1024.json``); the reference at TF32
in the program's place, a selection fault and a sketch block quantised
by truncation each fail one; the store is deleted after ``state``, after
a failed build, and never written without the disk for it. Nothing here
imports JAX."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.harness import check, gen
from portbench.harness.manifest import ROOT, Manifest
from portbench.harness.window import Window

N, BLK, SAMPLE, SHARD = 40_000, 4_096, 10_000, 8_192
B, POOL = 64, 256
SEED = 2**31 + 7
CELL = "stream-centres10m.sketch-b1024"
ROUTES = ["maxfirst", "carry"]


def _cell():
    man = Manifest(ROOT)
    w = man.workload(CELL)
    cfg = man.config(w["config"])
    cfg["shape"]["n_items"] = N
    cfg["store"].update(block_rows=BLK, rows_per_shard=SHARD, sample_rows=SAMPLE)
    return man, cfg, man.traffic(w["traffic"]), man.module("modes", cfg["mode"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One build, a window of refined answers by each route and of each
    fault, the state (the store then gone), the reference and the control."""
    man, cfg, traffic, mode = _cell()
    law = man.module("corpora", cfg["corpus"]["law"])
    cache = tmp_path_factory.mktemp("cache")
    mode.CACHE = cache
    k, alpha, cand = int(traffic["k"]), float(traffic["alpha"]), int(traffic["candidates"])
    X = gen.corpus(cfg, law, SEED, torch.device("cpu"))
    pool = gen.query_pool(cfg, law, POOL, SEED, torch.device("cpu"))
    idx, gl, stages = mode.build(cfg, X)
    store = idx.directory
    assert store.parent == cache and (store / "lambdas.bin").is_file()

    def window(route, kk=k, first=0):
        idx.sketch_maxfirst = route == "maxfirst"
        assert idx._sketch_maxfirst_route(B, k, cand) is (route == "maxfirst")
        answers = []
        for q0 in range(0, POOL, B):
            ids, sc = idx.search_batch_sketch(pool[q0:q0 + B], kk, alpha, candidates=cand)
            answers.append((np.arange(q0, q0 + B), ids[:, first:], sc[:, first:]))
        return Window(seconds=1.0, attempted=POOL, completed=POOL, answers=answers, setup_end=0.0)

    wins = {r: window(r) for r in ROUTES}
    faults = {r: window(r, 2 * k, k) for r in ROUTES}        # ranks k + 1 to 2k
    state = mode.state(cfg, idx, gl)
    ref = mode.reference(cfg, X, state)
    ctrl = mode.reference(cfg, X, None, "tf32")
    cstate = mode.reference_state(ctrl)
    cwin = Window(seconds=1.0, attempted=POOL, completed=POOL,
                  answers=mode.answers(ctrl, traffic, pool), setup_end=0.0)
    return dict(mode=mode, cfg=cfg, traffic=traffic, X=X, pool=pool, store=store, stages=stages,
                state=state, ref=ref, wins=wins, faults=faults, cstate=cstate, cwin=cwin, law=law,
                cache=cache)


def _judge(run, state, win):
    readings, extra = run["mode"].judge(run["cfg"], run["traffic"], run["ref"], state,
                                        run["pool"], win)
    return readings, extra, check.verdict(readings, run["traffic"]["limits"])


@pytest.mark.parametrize("route", ROUTES)
def test_refined_answers_hold_to_the_reference(run, route):
    readings, _, (ok, checks) = _judge(run, run["state"], run["wins"][route])
    assert ok, checks
    assert readings["bad_ids"] == 0 and readings["recall"] > 0.9


@pytest.mark.parametrize("reading", ["item_lambda_err", "assign_mismatch",
                                     "sketch_code_mismatch", "sketch_mult_err"])
def test_build_holds_to_the_reference(run, reading):
    readings, extra, _ = _judge(run, run["state"], run["wins"]["carry"])
    assert readings[reading] <= run["traffic"]["limits"][reading]
    assert extra["centroids"] == len(run["state"]["centroids"])


def test_the_sample_is_the_builds_strided_sample(run):
    """The program's assignments cover the sample the reference replays,
    which the configuration's 10,000 rows of 40,000 take every 4th row."""
    a = run["state"]["assignments"]
    assert a.shape == (SAMPLE,) and np.array_equal(a, run["ref"].clustering.assignments)
    from portbench.reference.streaming import sample

    assert torch.equal(sample(run["X"], SAMPLE), run["X"][::4])


def test_the_tf32_control_fails(run):
    _, _, (ok, checks) = _judge(run, run["cstate"], run["cwin"])
    assert not ok
    failed = {n for n, c in checks.items() if c["value"] > c["limit"]}
    assert {"sketch_code_mismatch", "sketch_mult_err", "item_lambda_err"} <= failed, checks


@pytest.mark.parametrize("route", ROUTES)
def test_a_selection_fault_fails(run, route):
    """Ranks 11–20, with their own exact scores, in order: only recall
    catches them."""
    _, _, (ok, checks) = _judge(run, run["state"], run["faults"][route])
    failed = {n for n, c in checks.items() if c["value"] > c["limit"]}
    assert not ok and failed == {"recall_shortfall"}, checks


def test_a_sketch_block_quantised_by_truncation_fails(run):
    """The codes of one 4,096-row block truncated toward zero instead of
    rounded: the sketch's codes give it away, whatever the answers."""
    ref = run["ref"]
    codes = run["state"]["codes"].clone()
    from portbench.reference.streaming import quantize
    from portbench.reference.eigen import Precision

    v, _ = quantize(run["X"][2 * BLK:3 * BLK], Precision("f64"))
    codes[2 * BLK:3 * BLK] = torch.trunc(v).to(torch.int8)
    readings, _, (ok, checks) = _judge(run, dict(run["state"], codes=codes), run["wins"]["carry"])
    assert not ok and readings["sketch_code_mismatch"] > 1000, checks
    assert ref.sketch_readings(run["state"]["codes"], run["state"]["mults"])[
        "sketch_code_mismatch"] == 0


def test_the_store_is_deleted_after_state(run):
    assert not run["store"].exists()
    assert list(run["cache"].iterdir()) == []
    assert {"store_write_s", "lambda_pass_s", "sketch_upload_s"} <= set(run["stages"])


def test_the_store_is_deleted_after_a_failed_build(tmp_path, monkeypatch):
    from matternet_rs_tpu_torch.index.streaming import StreamingIndex

    man, cfg, _, mode = _cell()
    monkeypatch.setattr(mode, "CACHE", tmp_path)

    def broken(directory, *a, **kw):
        assert (directory / "shards.json").is_file()
        raise RuntimeError("the build failed")

    monkeypatch.setattr(StreamingIndex, "build_from_store", broken)
    X = gen.corpus(dict(cfg, shape={"n_items": 5_000, "n_features": 96}),
                   man.module("corpora", cfg["corpus"]["law"]), 3, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="the build failed"):
        mode.build(cfg, X)
    assert list(tmp_path.iterdir()) == []


def test_too_little_disk_fails_before_writing(tmp_path, monkeypatch):
    man, cfg, _, mode = _cell()
    monkeypatch.setattr(mode, "CACHE", tmp_path)
    monkeypatch.setattr(mode.shutil, "disk_usage",
                        lambda p: type("U", (), {"free": mode.disk_bytes(5_000, 96) - 1})())
    X = torch.zeros((5_000, 96))
    with pytest.raises(RuntimeError, match="bytes of disk"):
        mode.build(cfg, X)
    assert list(tmp_path.iterdir()) == []


def test_disk_bytes_at_the_cells_shape():
    """The full cell's store, sketch, λ and multipliers: about 5 GB."""
    from portbench.modes import stream

    assert 4.8e9 < stream.disk_bytes(10_000_000, 96) < 5.6e9


def test_corpus_and_queries_share_the_laws_centres(run):
    """Every row lies near one of the law's 256 centres (unit noise in 96
    coordinates: ≈ √96 away), corpus rows and queries alike."""
    c = run["law"].centres(96, torch.device("cpu"))
    for rows in (run["X"][:2000], torch.from_numpy(run["pool"])):
        d = torch.cdist(rows, c).min(dim=1).values
        assert float(d.max()) < 14.0 and float(d.min()) > 6.0


def test_the_reference_imports_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, {root!r}); "
            "import portbench.reference.streaming; "
            "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))").format(
        root=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       timeout=300, check=True)
    import json

    names = set(json.loads(r.stdout.splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "matternet_rs_tpu", "matternet_rs_tpu_torch"}


def _altered(ids, sc):
    ids = ids.copy()
    ids[0, 0] = (ids[0, 0] + 1) % TINY_N
    return ids, sc


def _half_left_out(ids, sc):
    ids, sc = ids.copy(), sc.copy()
    h = len(ids) // 2
    ids[h:2 * h], sc[h:2 * h] = ids[:h], sc[:h]
    return ids, sc


TINY_N = 16_384


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """The benchmark cut as its own CPU tests cut it (16,384 rows, batches
    of 64 from a pool of 256), the store in 4,096-row blocks."""
    import json

    from portbench.tests.conftest import copy_bench

    root = copy_bench(tmp_path_factory.mktemp("tiny"), TINY_N)
    p = root / "portbench" / "configs" / "stream-centres10m.json"
    cfg = json.loads(p.read_text())
    cfg["store"].update(block_rows=BLK, rows_per_shard=SHARD)
    p.write_text(json.dumps(cfg))
    return root


@pytest.mark.parametrize("fault", ["none", "altered", "half_left_out", "ranks_11_to_20"])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    """A whole run of the cell on the CPU, with the answer altered where the
    sketch search produces it: one id of the first query, half of the
    batch answered with the other half's results, or ranks 11–20."""
    from matternet_rs_tpu_torch.index.streaming import StreamingIndex
    from portbench.harness.cell import run_cell

    orig = StreamingIndex.search_batch_sketch

    def broken(self, Q, k, *a, **kw):
        if fault == "ranks_11_to_20":
            ids, sc = orig(self, Q, 2 * k, *a, **kw)
            return ids[:, k:].copy(), sc[:, k:].copy()
        out = orig(self, Q, k, *a, **kw)
        return {"none": lambda i, s: (i, s), "altered": _altered,
                "half_left_out": _half_left_out}[fault](*out)

    monkeypatch.setattr(StreamingIndex, "search_batch_sketch", broken)
    out = run_cell(CELL, 5, 0.3, False, "cpu", root=tiny_root)
    assert out["correct"] is (fault == "none"), out["checks"]
    assert not list((tiny_root / ".portbench_cache").glob("stream-*"))
