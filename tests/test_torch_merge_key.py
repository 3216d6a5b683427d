"""Kernel G's merge orders candidates by one 64-bit key (``csrc/
search_fused.cu``, mirrored by ``search_fused.order_keys``), with the
candidate's position breaking equal keys. Held here on the CPU: the key
order is ``before()`` (score descending, id ascending, −0.0 equal to +0.0),
and the best k by (key, position) are ``merge_partials_plain``'s bit for bit
on any lists — ties, ±0.0, −inf with ``EMPTY_ID``, unsorted input."""

import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from matternet_rs_tpu_torch.ops.kernels import search_fused as tsf

SCORES = st.one_of(
    st.sampled_from([0.0, -0.0, 1.0, -1.0, 0.5, float("-inf"), float("inf"), -3.0e38,
                     1e-45, -1e-45]),
    st.floats(width=32, allow_nan=False),
)
IDS = st.one_of(st.integers(0, 6), st.just(tsf.EMPTY_ID), st.integers(-2**31, 2**31 - 1))
PAIRS = st.tuples(SCORES, IDS)


def _before(a, b):
    """``before()`` of csrc/search_fused.cu on float32 scores."""
    (s, i), (v, j) = a, b
    s, v = np.float32(s), np.float32(v)
    return bool(s > v or (s == v and i < j))


@settings(max_examples=300, deadline=None, database=None)
@given(PAIRS, PAIRS)
def test_key_order_is_before(a, b):
    ka, kb = tsf.order_keys([a[0], b[0]], [a[1], b[1]])
    assert (ka > kb) == _before(a, b)
    assert (kb > ka) == _before(b, a)
    assert (ka == kb) == (not _before(a, b) and not _before(b, a))


def _merge_by_keys(vals, ids, k):
    b = vals.shape[0]
    v, i = vals.reshape(b, -1).numpy(), ids.reshape(b, -1).numpy()
    pos = np.arange(v.shape[1])
    out_v, out_i = [], []
    for r in range(b):
        order = np.lexsort((pos, ~tsf.order_keys(v[r], i[r])))[:k]
        out_v.append(v[r][order])
        out_i.append(i[r][order])
    return torch.from_numpy(np.stack(out_i)), torch.from_numpy(np.stack(out_v))


@settings(max_examples=150, deadline=None, database=None)
@given(st.lists(PAIRS, min_size=16, max_size=80), st.integers(1, 16), st.randoms())
def test_best_k_by_key_and_position_is_the_plain_merge(pairs, k, rnd):
    pairs = pairs[:len(pairs) // 8 * 8]
    rnd.shuffle(pairs)
    vals = torch.tensor([p[0] for p in pairs], dtype=torch.float32).view(1, -1, 8)
    ids = torch.tensor([p[1] for p in pairs], dtype=torch.int32).view(1, -1, 8)
    k = min(k, vals.numel())
    want_i, want_v = tsf.merge_partials_plain(vals, ids, k)
    got_i, got_v = _merge_by_keys(vals, ids, k)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))   # bit for bit


def test_edge_keys():
    keys = tsf.order_keys([0.0, -0.0, float("-inf"), float("-inf"), float("nan"), float("inf")],
                          [3, 3, 5, tsf.EMPTY_ID, 0, 0])
    assert keys[0] == keys[1]                              # ±0.0 tie, then by id
    assert keys[2] > keys[3] > 0                           # −inf entries, EMPTY_ID last, above nothing
    assert keys[4] > keys[5]                               # NaN above +inf, as a descending sort puts it


def test_ties_fall_to_ids_then_to_positions():
    vals = torch.tensor([[[0.5] * 8, [-0.0] * 4 + [0.0] * 4]], dtype=torch.float32)
    ids = torch.tensor([[[9, 3, 7, 3, 1, 8, 2, 5], [4, 4, 1, 6, 4, 4, 1, 6]]], dtype=torch.int32)
    for k in (1, 10, 16):
        want_i, want_v = tsf.merge_partials_plain(vals, ids, k)
        got_i, got_v = _merge_by_keys(vals, ids, k)
        assert torch.equal(got_i, want_i)
        assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
