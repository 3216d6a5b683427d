"""Port vs reference: kernel B's and kernel C's plain versions against the
Pallas kernels in interpret mode, the fused tile-max path end to end, and
the lowest-index-first tie order.

Tolerances: scores ≤ 1e-5 abs (f32 summation order); the gather is a copy
and must match bit for bit; ids equal up to the near-tie rule of
``matternet_rs_tpu_torch.utils.parity``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matternet_rs_tpu.ops import search as jso
from matternet_rs_tpu.ops.pallas import tilemax_fused as jtmf

from matternet_rs_tpu_torch.ops import search as tso
from matternet_rs_tpu_torch.ops.kernels import tilemax as ttmk
from matternet_rs_tpu_torch.utils.parity import topk_mismatches


def _fixture(n, f, b, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f), dtype=np.float32)
    X[3] = 0.0                                 # exercises the guarded cosine
    norms = np.sqrt(np.sum(X * X, axis=1)).astype(np.float32)
    lams = rng.random(n, dtype=np.float32)
    Q = rng.standard_normal((b, f), dtype=np.float32)
    ql = rng.random(b, dtype=np.float32)
    al = rng.uniform(0.3, 0.9, b).astype(np.float32)
    return X, norms, lams, Q, ql, al


def _jax(arrs):
    return [jnp.asarray(a) for a in arrs]


def _torch(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


@pytest.mark.parametrize("mask_from", [None, 3000])
@pytest.mark.parametrize("f", [32, 128, 256])
def test_scores_and_tilemax_plain_matches_pallas(f, mask_from):
    arrs = _fixture(4500, f, 8, seed=f)
    ref_s, ref_m = jtmf.scores_and_tilemax(
        *_jax(arrs), tile=2048, interpret=True,
        mask_from=None if mask_from is None else jnp.int32(mask_from),
    )
    got_s, got_m = ttmk.scores_and_tilemax_plain(*_torch(arrs), tile=2048, mask_from=mask_from)
    assert got_s.shape == ref_s.shape and got_m.shape == ref_m.shape
    ref_s, ref_m = np.asarray(ref_s), np.asarray(ref_m)
    finite = np.isfinite(ref_s)
    assert np.array_equal(finite, np.isfinite(got_s.numpy()))
    assert np.max(np.abs(ref_s[finite] - got_s.numpy()[finite])) <= 1e-5
    fm = np.isfinite(ref_m)
    assert np.array_equal(fm, np.isfinite(got_m.numpy()))
    assert np.max(np.abs(ref_m[fm] - got_m.numpy()[fm])) <= 1e-5


def test_gather_subtiles_plain_matches_pallas_bitwise():
    rng = np.random.default_rng(11)
    b, ns, ts, c = 8, 40, 128, 6
    S = rng.standard_normal((b, ns * ts), dtype=np.float32)
    sel = np.sort(rng.integers(0, ns, size=(b, c), dtype=np.int32), axis=1)
    ref = jtmf.gather_subtiles(jnp.asarray(S), jnp.asarray(sel), ts, interpret=True)
    got = ttmk.gather_subtiles(torch.from_numpy(S), torch.from_numpy(sel).long(), ts)
    assert np.array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("n,f", [(9000, 64), (9000, 200)])
def test_fused_tilemax_matches_reference_fused_path(n, f):
    """The port's fused path (plain versions on the CPU) against the
    reference's fused producer + DMA gather in interpret mode."""
    b, tile, k = 8, 2048, 5
    arrs = _fixture(n, f, b, seed=3)
    X, norms, lams, Q, ql, al = _jax(arrs)
    nt0 = n // tile
    n0, ts, ns = nt0 * tile, tile // jtmf.SUBS, nt0 * jtmf.SUBS
    smain, submax = jtmf.scores_and_tilemax(X, norms, lams, Q, ql, al, tile=tile, interpret=True)
    tail = jso._batched_scores(X, norms, lams, Q, ql, al)[:, n0:]
    ref_top, ref_idx = jso._tilemax_select(
        smain.reshape(b, ns, ts), submax, tail, n, k + 1, 4,
        gather=lambda sel: jtmf.gather_subtiles(smain, sel, ts, interpret=True),
    )
    top, idx = tso.fused_tilemax(*_torch(arrs)[:5], k, _torch(arrs)[5], tile)
    assert not topk_mismatches(ref_idx, ref_top, idx.numpy(), top.numpy())


@pytest.mark.parametrize("n", [70_000, 40_000])
def test_search_tilemax_matches_flat_reference(n):
    """Routed tile-max search (fused route at both sizes on the CPU) vs the
    reference's flat kernel."""
    arrs = _fixture(n, 32, 16, seed=5)
    k = 10
    ref_idx, ref_top = jax.vmap(
        lambda q, l, a: jso.search_lambda_aware(
            jnp.asarray(arrs[0]), jnp.asarray(arrs[1]), jnp.asarray(arrs[2]), q, l, k + 1, a
        )
    )(*_jax(arrs[3:]))
    X, norms, lams, Q, ql, al = _torch(arrs)
    assert tso.fused_fast_path(*X.shape, 16, X.dtype, k)
    idx, top = tso.search_lambda_aware_tilemax(X, norms, lams, Q, ql, k, al)
    assert not topk_mismatches(ref_idx, ref_top, idx.numpy(), top.numpy())


def test_topk_stable_breaks_exact_ties_lowest_index_first():
    scores = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 1.0],
                       [0.5, 0.5, 0.5, 0.5, 0.5, 0.5]], np.float32)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(scores), 4)
    got_v, got_i = tso.topk_stable(torch.from_numpy(scores), 4)
    assert np.array_equal(np.asarray(ref_i), got_i.numpy())
    assert np.array_equal(np.asarray(ref_v), got_v.numpy())
    assert got_i.tolist() == [[1, 2, 4, 3], [0, 1, 2, 3]]


def test_tilemax_selection_on_exact_ties_matches_reference():
    """Integer-valued scores tie everywhere; the selection must return the
    reference's ids exactly (lowest index first through the tile pruning)."""
    rng = np.random.default_rng(2)
    scores = rng.integers(0, 4, size=(8, 9000)).astype(np.float32)
    ref_v, ref_i = jso.tilemax_topk(jnp.asarray(scores), 7, tile=512)
    got_v, got_i = tso.tilemax_topk(torch.from_numpy(scores), 7, tile=512)
    assert np.array_equal(np.asarray(ref_i), got_i.numpy())
    assert np.array_equal(np.asarray(ref_v), got_v.numpy())


def test_fused_predicates_follow_reference_thresholds():
    X = torch.zeros(100_000, 128)
    assert tso.fused_supported(X, 64, 2048)
    assert not tso.fused_supported(X, 1, 2048)                    # B == 1
    assert not tso.fused_supported(X.to(torch.bfloat16), 64, 2048)
    assert not tso.fused_supported(torch.zeros(1000, 128), 64, 2048)
    assert not tso.fused_supported(torch.zeros(10, tso.MAX_FUSED_F + 1), 2, 8)
    assert tso._tilemax_degenerate(20_000, 10, 2048)
    assert not tso.fused_fast_path(20_000, 16, 16, torch.float32, 10)
