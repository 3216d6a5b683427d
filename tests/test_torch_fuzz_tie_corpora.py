"""The adversarial exact-tie corpora of ``tests/test_fuzz_invariants.py`` on
the port's plain routes (the CPU), with its seeds, sizes and tolerances,
each held to the reference's contract (PARITY.md): the score multiset
exactly a flat top-k's, ids distinct, in range and carrying their scores,
ids equal away from ties, rescored scores exact and above the k-th less the
tier's margin, padded rows never returned. The flat truth is the JAX
package's own (``_batched_scores`` and ``lax.top_k``, or its
``tilemax_topk``) on the same numpy input.

Also: the candidate stage's chain (``tilemax.select_topk_plain``, the plain
version of kernel C's route and of the ``subtile_topk`` kernels) on the same
score corpora, and the checks of ``chip_smoke.py``'s phase ``ties`` (its
hub corpora, which tie in every sub-tile, through ``search_batch``, the
``mask_from`` routes, the sketch scan, ``search_fused`` and the 4-slot
mesh) on the CPU at a small size; ``tests/test_torch_ties_gpu.py`` runs
them through the kernels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matternet_rs_tpu.core import _quantize_rows_device_jit
from matternet_rs_tpu.ops import search as jso

import chip_smoke
from matternet_rs_tpu_torch import core
from matternet_rs_tpu_torch.ops import search as so
from matternet_rs_tpu_torch.ops.kernels import tilemax as tmk

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flat_reference(X, lams, Q, qls, alphas):
    """The JAX package's flat blended scores ``[B, N]`` (numpy)."""
    norms = np.linalg.norm(X, axis=1).astype(np.float32)
    return np.asarray(jso._batched_scores(
        jnp.asarray(X), jnp.asarray(norms), jnp.asarray(lams), jnp.asarray(Q),
        jnp.asarray(qls), jnp.asarray(alphas)))


@pytest.mark.parametrize("seed", range(6))
def test_random_tilemax_tie_dense_score_multiset_exact(seed):
    """Quantised scores with few distinct values: ``tilemax_topk``'s score
    multiset equals flat top-k's exactly; ids distinct, in range, carrying
    their scores; and the reference's ``tilemax_topk`` returns the same
    ids and values bit for bit."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5_000, 40_000))
    k = int(rng.choice([1, 5, 10, 32]))
    tile = int(rng.choice([256, 512, 1024]))
    levels = int(rng.choice([2, 3, 17]))
    scores_np = rng.integers(0, levels, (4, n)).astype(np.float32) / levels
    want_s, _ = jax.lax.top_k(jnp.asarray(scores_np), min(k, n))
    got_s, got_i = so.tilemax_topk(_t(scores_np), k, tile=tile)
    got_s, got_i = got_s.numpy(), got_i.numpy()
    np.testing.assert_array_equal(got_s, np.asarray(want_s))
    for row in range(4):
        ids = got_i[row]
        assert len(set(ids.tolist())) == len(ids)
        assert (0 <= ids).all() and (ids < n).all()
        np.testing.assert_array_equal(scores_np[row][ids], got_s[row])
    ref_s, ref_i = jso.tilemax_topk(jnp.asarray(scores_np), k, tile=tile)
    np.testing.assert_array_equal(got_i, np.asarray(ref_i))
    np.testing.assert_array_equal(got_s, np.asarray(ref_s))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [10, 40, 100, 200])
def test_candidate_stage_chain_on_tie_dense_scores(seed, k):
    """The same corpora through the candidate stage's selection chain at
    kernel B's 256-row sub-tiles (``select_topk_plain``: the route of
    kernel C, and the definition the one-launch ``subtile_topk`` kernels
    equal bit for bit) at the exact tier's k: the score multiset is flat
    top-k's exactly, the ids are ``topk_stable``'s (lowest index first)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(60_000, 120_000))
    levels = int(rng.choice([2, 3, 17]))
    s = _t(rng.integers(0, levels, (4, n)).astype(np.float32) / levels)
    ts, ns = tmk.KERNEL_TS, n // tmk.KERNEL_TS
    n0 = ns * ts
    main = s[:, :n0].reshape(4, ns, ts)
    tail = s[:, n0:] if n0 < n else None
    top, idx = tmk.select_topk_plain(main, main.amax(dim=2), tail, n, k, so.SELECT_MARGIN)
    want_s, want_i = so.topk_stable(s, k)
    assert torch.equal(top, want_s)
    assert torch.equal(idx, want_i)
    np.testing.assert_array_equal(np.asarray(jax.lax.top_k(jnp.asarray(s.numpy()), k)[0]), top.numpy())


def _wide_f_case(f, seed):
    rng = np.random.default_rng(400 + seed)
    n = int(rng.integers(so.FUSED_TILEMAX_MIN_N + 1, 40_000))
    b, k = 16, int(rng.choice([5, 10]))
    levels = int(rng.choice([2, 3]))
    X = rng.integers(-levels, levels + 1, (n, f)).astype(np.float32)
    X[rng.integers(0, n, n // 4)] = X[rng.integers(0, n, n // 4)]
    lams = (rng.integers(0, 4, n) / 4.0).astype(np.float32)
    q_rows = rng.integers(0, n, b)
    return X, lams, q_rows, k


@pytest.mark.parametrize("f,seed", [(256, 0), (256, 1), (512, 2), (1536, 3)])
def test_random_fused_wide_f_tie_corpus(f, seed):
    """The fused wide-F producer's envelope (128 < F ≤ 2048, n ≥
    FUSED_TILEMAX_MIN_N) on integer corpora with exact duplicate rows,
    through ``search_lambda_aware_tilemax`` (the route ``search_batch``
    takes at this n): scores the flat kernel's within 2e-5, ids distinct,
    in range and at or above the flat k-th, a tie-free k-boundary gives the
    flat ids, self-queries find themselves or an equal duplicate."""
    X, lams, q_rows, k = _wide_f_case(f, seed)
    n, b = X.shape[0], len(q_rows)
    Q, qls = X[q_rows].copy(), lams[q_rows].copy()
    alphas = np.full(b, 0.7, np.float32)
    norms = np.linalg.norm(X, axis=1).astype(np.float32)
    assert so.fused_fast_path(n, f, b, np.float32, k)

    idx, top = so.search_lambda_aware_tilemax(_t(X), _t(norms), _t(lams), _t(Q), _t(qls), k,
                                              _t(alphas))
    idx, top = idx.numpy(), top.numpy()
    sref = _flat_reference(X, lams, Q, qls, alphas)
    ft, fi = (np.asarray(a) for a in jax.lax.top_k(jnp.asarray(sref), k))

    np.testing.assert_allclose(top, ft, atol=TOL, rtol=1e-5)
    for row in range(b):
        ids = idx[row]
        assert len(set(ids.tolist())) == len(ids)
        assert (0 <= ids).all() and (ids < n).all()
        assert (sref[row][ids] >= ft[row][-1] - TOL).all()
        boundary_gap = ft[row][-1] - np.partition(sref[row], -(k + 1))[-(k + 1)]
        if boundary_gap > 2 * TOL and not np.isclose(ft[row][:-1], ft[row][1:], rtol=0,
                                                      atol=2 * TOL).any():
            np.testing.assert_array_equal(np.sort(ids), np.sort(fi[row]))
        assert q_rows[row] in ids.tolist() or np.isclose(
            sref[row][ids], sref[row][q_rows[row]], rtol=0, atol=TOL).any()


def _tie_corpus(rng, n, f):
    levels = int(rng.choice([2, 3]))
    X = rng.integers(-levels, levels + 1, (n, f)).astype(np.float32)
    X[rng.integers(0, n, n // 4)] = X[rng.integers(0, n, n // 4)]
    lams = (rng.integers(0, 4, n) / 4.0).astype(np.float32)
    return X, lams


@pytest.mark.parametrize("tier,seed", [("bf16x3", 0), ("bf16x3", 1), ("int8", 2), ("int8", 3)])
def test_random_fused_rescored_tie_corpus(tier, seed):
    """The maxima-first rescored selection (``fused_scan_rescored``: kernel
    D's plain version, then kernel E's) on the same corpora, row for row:
    every returned score is its id's exact flat score; every id clears the
    flat k-th less the tier's margin; bf16x3 (exact integer dots) returns
    flat top-k's score multiset; ids distinct and in range; self-queries
    find themselves or an equal duplicate. The int8 sketch is the JAX
    package's quantisation of the same rows, bit for bit."""
    rng = np.random.default_rng(600 + seed)
    n = int(rng.integers(so.FUSED_TILEMAX_MIN_N + 1, 40_000))
    f, b, k = 128, 16, int(rng.choice([5, 10]))
    X, lams = _tie_corpus(rng, n, f)
    norms = np.linalg.norm(X, axis=1).astype(np.float32)
    q_rows = rng.integers(0, n, b)
    Q, qls = X[q_rows].copy(), lams[q_rows].copy()
    alphas = np.full(b, 0.7, np.float32)
    cand = max(4 * k, 32)
    assert so.fused_rescored_path(n, f, b, k, cand)

    if tier == "int8":
        Xscan, scan_rn = core.quantize_rows(_t(X))
        j8, jrn = _quantize_rows_device_jit(jnp.asarray(X))
        np.testing.assert_array_equal(Xscan.numpy(), np.asarray(j8))
        margin = 0.03
    else:
        Xscan, scan_rn = _t(X), None
        margin = 2e-5
    idx, top = so.fused_scan_rescored(Xscan, _t(X), _t(norms), _t(lams), _t(Q), _t(qls), k, cand,
                                      _t(alphas), scan_rn=scan_rn)
    idx, top = idx.numpy(), top.numpy()
    sref = _flat_reference(X, lams, Q, qls, alphas)
    ft = np.asarray(jax.lax.top_k(jnp.asarray(sref), k)[0])
    for row in range(b):
        ids = idx[row]
        assert len(set(ids.tolist())) == len(ids)
        assert (0 <= ids).all() and (ids < n).all()
        np.testing.assert_allclose(top[row], sref[row][ids], rtol=1e-6, atol=TOL)
        assert (sref[row][ids] >= ft[row][-1] - margin - TOL).all()
        if tier == "bf16x3":
            np.testing.assert_allclose(top[row], ft[row], rtol=0, atol=TOL)
        assert q_rows[row] in ids.tolist() or np.isclose(
            sref[row][ids], sref[row][q_rows[row]], rtol=0, atol=margin + TOL).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_rescored_mask_from_pad_rows(seed):
    """``mask_from`` on the rescored route: padded zero rows with the first
    query's λ never come back, and the real rows keep their contract
    (exact scores, the flat score multiset)."""
    rng = np.random.default_rng(700 + seed)
    n = int(rng.integers(so.FUSED_TILEMAX_MIN_N + 1, 38_000))
    f, b, k = 128, 16, 10
    X, lams = _tie_corpus(rng, n, f)
    q_rows = rng.integers(0, n, b)
    Q, qls = X[q_rows].copy(), lams[q_rows].copy()
    pad = int(rng.integers(1, 3000))
    Xp = np.concatenate([X, np.zeros((pad, f), np.float32)])
    lamsp = np.concatenate([lams, np.full(pad, qls[0], np.float32)])
    normsp = np.linalg.norm(Xp, axis=1).astype(np.float32)
    alphas = np.full(b, 0.7, np.float32)
    cand = max(4 * k, 32)
    assert so.fused_rescored_path(n + pad, f, b, k, cand)

    idx, top = so.fused_scan_rescored(_t(Xp), _t(Xp), _t(normsp), _t(lamsp), _t(Q), _t(qls), k,
                                      cand, _t(alphas), mask_from=n)
    idx, top = idx.numpy(), top.numpy()
    sref = _flat_reference(X, lams, Q, qls, alphas)
    ft = np.asarray(jax.lax.top_k(jnp.asarray(sref), k)[0])
    for row in range(b):
        ids = idx[row]
        assert (ids < n).all(), f"pad row leaked: {ids[ids >= n]}"
        assert (0 <= ids).all() and len(set(ids.tolist())) == len(ids)
        np.testing.assert_allclose(top[row], sref[row][ids], rtol=1e-6, atol=TOL)
        np.testing.assert_allclose(top[row], ft[row], rtol=0, atol=TOL)


def test_tie_phase_checks_hold_on_the_plain_routes():
    """``chip_smoke.tie_checks`` on the CPU at a small size (the hub
    corpora, 32 queries, a mesh of 4 CPU slots): every check passes on the
    plain routes, padded rows would win unmasked, and the model of the
    wide candidate stage sends the hub queries through its radix select."""
    records, _ = chip_smoke.tie_checks(torch.device("cpu"), n_main=65_536, levels=(2, 17),
                                       f_wide=(256,), mesh_n=131_073, b=32)
    assert [r for r in records if not r["ok"]] == []
    assert len(records) == 2 * 10 + 6 + 4 + 3
    assert all(r["pad_rows_win_unmasked"] > 0 for r in records if "pad_rows_win_unmasked" in r)
    radix = [r["radix_rows"] for r in records if "radix_rows" in r]
    assert len(radix) == 4 and min(radix) >= 32 // chip_smoke.TIE_HUB_SHARE
