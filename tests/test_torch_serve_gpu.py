"""Serving on the card: an index of 65,536 × 128 rows built on the card
and served by ``IndexService``. Requests are placed in the queue under the
service's lock, so the batches the collector cuts are known. Every test
needs a CUDA card and ``nvcc`` (marker ``gpu``) and skips without them.
This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_serve_gpu.py

Checks: one dispatch of 256 mixed-alpha requests launches its tier's
kernels once each (every tier: the query kernel; the exact tier: kernel B
and the candidate stage; the maxima-first tiers: kernels D and E) and
answers bit for bit as the direct
``search_batch``; two dispatch threads inside ``_run_batch`` at once (a
barrier holds each until the other arrives) answer as the serial calls,
and the launch counts are exact.
"""

import threading

import numpy as np
import pytest
import torch

from matternet_rs_tpu_torch import backend
from matternet_rs_tpu_torch import serve as tsv
from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder
from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

pytestmark = pytest.mark.gpu

N, F, B, K = 65_536, 128, 256, 10
ALPHAS = (0.5, 0.6, 0.7, 0.8, 0.9, 0.95)
TIER_KERNELS = {False: ("taumode_query", "scores_tilemax", "subtile_topk"),
                "bf16x3_rescored": ("taumode_query", "tilemax_only", "slab_dots"),
                "int8_rescored": ("taumode_query", "tilemax_only", "slab_dots")}
TIMEOUT = 120


@pytest.fixture(scope="module")
def index():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if backend.nvcc_path() is None:
        pytest.skip("needs nvcc to build the kernels")
    data = make_energy_test_dataset(N, F, seed=44).astype(np.float32)
    aspace, gl = (ArrowSpaceBuilder().with_lambda_graph(1.0, 6).with_sparsity_check(False)
                  .with_cluster_params(max_clusters=64, radius=25.0).with_sampling(None)
                  .build(data))
    rows = np.random.default_rng(5).choice(N, 2 * B, replace=False)
    alphas = np.asarray([ALPHAS[i % len(ALPHAS)] for i in range(B)], np.float32)
    for tier in TIER_KERNELS:             # make the lazy copies and build the kernels
        aspace.search_batch(data[rows[:B]], gl, K, alphas, quantized=tier)
    torch.cuda.synchronize()
    return data, aspace, gl, rows, alphas


def _fill(svc, groups):
    """Place every request of ``groups`` (lists of pending requests) in the
    queue under the lock, and wait for all of them."""
    with svc._cv:
        for g in groups:
            svc._queue.extend(g)
        svc._cv.notify_all()
    for g in groups:
        for p in g:
            assert p.done.wait(TIMEOUT), "a request was never answered"
            assert p.error is None, p.error


def _requests(svc, data, rows, alphas, k, tier):
    return [tsv._Pending(svc._validate(data[r]), k, float(a), False, "blend", quantized=tier)
            for r, a in zip(rows, alphas)]


def _same(pending, idx, sc):
    for p, ri, rs in zip(pending, idx, sc):
        assert [r["index"] for r in p.result] == ri.tolist()
        got = np.asarray([r["score"] for r in p.result], np.float32)
        assert np.array_equal(got.view(np.int32), rs.view(np.int32))


@pytest.mark.parametrize("tier", list(TIER_KERNELS), ids=str)
def test_one_dispatch_launches_each_kernel_once(index, tier):
    data, aspace, gl, rows, alphas = index
    svc = tsv.IndexService(aspace, gl, batch_window_ms=5000.0, max_batch=B)
    try:
        pend = _requests(svc, data, rows[:B], alphas, K, tier)
        torch.cuda.synchronize()
        kernels.reset_launches()
        _fill(svc, [pend])
        counts = kernels.launch_counts()
        assert svc.n_batches == 1
        assert counts == {k: int(k in TIER_KERNELS[tier]) for k in kernels.LAUNCHES}, counts
        _same(pend, *aspace.search_batch(data[rows[:B]], gl, K, alphas, quantized=tier))
    finally:
        svc.close()


@pytest.mark.parametrize("second", [False, "bf16x3_rescored"], ids=str)
def test_two_dispatch_threads_launch_at_once(index, second):
    """Two groups in one cut (k = 10 exact, and k = 5 on ``second``) go to
    the two dispatch workers; a barrier in ``_run_batch`` holds each until
    the other is inside too. Eight rounds: every answer equals the serial
    call, and each kernel's count is exactly what the serial calls launch."""
    data, aspace, gl, rows, alphas = index
    svc = tsv.IndexService(aspace, gl, batch_window_ms=5000.0, max_batch=B)
    barrier, orig = threading.Barrier(2, timeout=TIMEOUT), svc._run_batch

    def both_inside(*a, **kw):
        barrier.wait()
        return orig(*a, **kw)

    svc._run_batch = both_inside
    rounds = 8
    try:
        got = []
        torch.cuda.synchronize()
        kernels.reset_launches()
        for _ in range(rounds):
            first = _requests(svc, data, rows[:B], alphas, K, False)
            other = _requests(svc, data, rows[B:], alphas, 5, second)
            _fill(svc, [first, other])
            got.append((first, other))
        counts = kernels.launch_counts()
        assert svc.n_batches == 2 * rounds
        want = {k: 0 for k in kernels.LAUNCHES}
        for tier in (False, second):
            for name in TIER_KERNELS[tier]:
                want[name] += rounds
        assert counts == want, counts
        ref_first = aspace.search_batch(data[rows[:B]], gl, K, alphas)
        ref_other = aspace.search_batch(data[rows[B:]], gl, 5, alphas, quantized=second)
        for first, other in got:
            _same(first, *ref_first)
            _same(other, *ref_other)
    finally:
        svc.close()
