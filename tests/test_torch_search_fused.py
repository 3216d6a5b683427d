"""Port vs reference: ``search_fused`` (kernel G's plain route on the CPU)
against the TPU kernel ``search_fused_pallas`` in interpret mode.

Both take full-f32 dots of the same pre-normalised rows, so the ids come in
the same order — exact score ties included (lowest id first) — and the
scores agree within 1e-6 (the dot's summation order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu.ops.pallas import search_fused as jsf

from matternet_rs_tpu_torch import search_fused as exported_search_fused
from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops.kernels import search_fused as tsf


def _fixture(n, f, b, seed, ties=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    lam = rng.random(n).astype(np.float32)
    if ties:
        X[100:140] = X[7]                 # forty copies of row 7: exact score ties
        lam[100:140] = lam[7]
    Xn = X / np.linalg.norm(X, axis=1, keepdims=True)
    return Xn, lam, Xn[:b].copy(), rng.random(b).astype(np.float32)


def _both(arrs, k, alpha=0.7):
    ref_idx, ref_val = jsf.search_fused_pallas(*(jnp.asarray(a) for a in arrs), k, alpha,
                                               interpret=True)
    idx, val = tsf.search_fused(*(torch.from_numpy(a) for a in arrs), k, alpha)
    return np.asarray(ref_idx), np.asarray(ref_val), idx, val


@pytest.mark.parametrize("n,f,b,k,alpha,ties", [
    (3000, 64, 8, 10, 0.7, False),        # the reference test's fixture
    (2777, 48, 11, 16, 0.7, True),        # ties; N, F and B off every TPU pad
    (700, 100, 3, 1, 0.35, True),
])
def test_search_fused_matches_pallas_interpret(n, f, b, k, alpha, ties):
    arrs = _fixture(n, f, b, seed=12, ties=ties)
    kernels.reset_launches()
    ref_idx, ref_val, idx, val = _both(arrs, k, alpha)
    assert kernels.launch_counts() == {name: 0 for name in kernels.LAUNCHES}
    assert idx.dtype == torch.int32 and tuple(idx.shape) == ref_idx.shape == (b, k)
    assert np.array_equal(ref_idx, idx.numpy())
    assert np.allclose(ref_val, val.numpy(), atol=1e-6)
    assert bool(torch.all(val[:, 1:] <= val[:, :-1]))
    if ties:                              # equal scores come lowest id first
        same = val[:, 1:] == val[:, :-1]
        if k > 1:
            assert bool(same.any())
        assert bool(torch.all(idx[:, 1:][same] > idx[:, :-1][same]))
    # ... and both are the exact blended ranking.
    Xn, lam, Qn, ql = arrs
    scores = alpha * (Qn @ Xn.T) + (1 - alpha) * (1 - np.minimum(np.abs(lam[None] - ql[:, None]), 1))
    top = np.sort(scores, axis=1)[:, ::-1][:, :k]
    assert np.allclose(val.numpy(), top, atol=1e-5)


def test_k_above_sixteen_raises_and_small_n_clamps():
    arrs = [torch.from_numpy(a) for a in _fixture(12, 8, 3, seed=13)]
    with pytest.raises(ValueError, match="K_PAD"):
        tsf.search_fused(*arrs, 17)
    ref_idx, ref_val, idx, val = _both(_fixture(12, 8, 3, seed=13), 16)     # N < k
    assert tuple(idx.shape) == ref_idx.shape == (3, 12)
    assert np.array_equal(ref_idx, idx.numpy())
    assert np.array_equal(np.sort(idx.numpy(), axis=1), np.tile(np.arange(12), (3, 1)))
    assert tsf.search_fused(*arrs, 0)[0].shape == (3, 1)                    # k < 1 keeps one
    assert exported_search_fused is tsf.search_fused


def test_rows_marked_as_padding_are_masked():
    """λ > 1.5 is the reference's mark for a padded row: it scores −3e38 in
    both packages and never enters a top-k that real rows can fill."""
    Xn, lam, Qn, ql = _fixture(600, 32, 4, seed=14)
    lam[0:4] = 2.0                        # the queries' own rows
    ref_idx, _, idx, val = _both((Xn, lam, Qn, ql), 10)
    assert np.array_equal(ref_idx, idx.numpy())
    assert not np.isin(idx.numpy(), np.arange(4)).any()
    assert float(val.min()) > -1.0


@pytest.mark.parametrize("splits", [1, 2, 7, 100])
def test_partial_lists_merge_to_the_same_answer_for_any_split_count(splits):
    """The plain versions of the two kernels: per-range sorted lists, then
    the merge under (score descending, id ascending). The order is total,
    so the number of ranges changes nothing."""
    arrs = [torch.from_numpy(a) for a in _fixture(2777, 48, 11, seed=15, ties=True)]
    want_idx, want_val = tsf.search_fused_plain(*arrs, 16)
    vals, ids = tsf.scan_partials(*arrs, 16, 0.7, splits)
    assert vals.shape == ids.shape == (11, splits, 16) and ids.dtype == torch.int32
    empty = ids == tsf.EMPTY_ID
    assert bool(torch.all(torch.isinf(vals[empty]))) and bool(torch.all(ids[~empty] < 2777))
    idx, val = tsf.merge_partials(vals, ids, 16)
    assert torch.equal(idx, want_idx) and torch.equal(val, want_val)
    idx10, val10 = tsf.merge_partials(vals, ids, 10)
    assert torch.equal(idx10, want_idx[:, :10]) and torch.equal(val10, want_val[:, :10])


def test_shape_and_range_checks():
    Xn, lam, Qn, ql = (torch.from_numpy(a) for a in _fixture(300, 16, 4, seed=16))
    with pytest.raises(ValueError, match="inconsistent"):
        tsf.scan_partials(Xn, lam[:-1], Qn, ql, 10, 0.7, 2)
    with pytest.raises(ValueError, match="out of range"):
        tsf.scan_partials(Xn, lam, Qn, ql, 10, 0.7, 0)
    with pytest.raises(ValueError, match="merge"):
        tsf.merge_partials(torch.zeros(4, 2, 16), torch.zeros(4, 2, 8, dtype=torch.int32), 10)
    assert tsf.k_keep(10, 3) == 3 and tsf.k_keep(0, 50) == 1 and tsf.k_keep(16, 50) == 16
