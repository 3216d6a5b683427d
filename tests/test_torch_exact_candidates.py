"""The exact tier's candidate stage on the CPU: the port's selection chain
(``tilemax.select_topk_plain``, the plain version of the one-launch
``subtile_topk`` kernel) against the reference's ``_tilemax_select`` with the
Pallas gather in interpret mode, on the same numpy inputs, bit for bit
(values and ids); the key order the kernels rank by, against the chain;
a numpy model of the wide kernel's selection (16 < k ≤ 128: thread-best
bar, compaction, radix select past the list's cap, ranks), against the
chain; and which route ``select_topk`` takes.

The kernel itself runs only on the card (``tests/test_torch_kernels_gpu.py``
and ``chip_smoke.py`` hold it against the chain bit for bit).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from matternet_rs_tpu.ops import search as jso
from matternet_rs_tpu.ops.pallas import tilemax_fused as jtmf

from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops import search as tso
from matternet_rs_tpu_torch.ops.kernels import search_fused as tsf
from matternet_rs_tpu_torch.ops.kernels import tilemax as ttmk

TS = ttmk.KERNEL_TS            # sub-tile width of the fused path
B, NS = 8, 140                 # the Pallas gather takes B % 8 == 0; c < NS up to kk = 128
MARGIN = tso.SELECT_MARGIN


def _scores(b, ns, nr, kind, seed):
    """Scores ``[b, ns·TS + nr]`` (sub-tiles, then the ragged tail) of one
    kind: random; integer-valued (equal maxima across sub-tiles, ties
    everywhere); the tail's best equal to the best of a sub-tile; −inf from
    ``mask_from`` inside a sub-tile, inside the tail, or after the fifth row
    (fewer finite scores than k)."""
    rng = np.random.default_rng(seed)
    n0 = ns * TS
    s = rng.standard_normal((b, n0 + nr), dtype=np.float32)
    if kind == "ties":
        s = rng.integers(0, 4, size=s.shape).astype(np.float32)
    elif kind == "tail_tie" and nr:
        s[:, n0 + nr // 2] = s[:, :n0].max(axis=1)
    mask_from = {"mask_subtile": n0 - TS - 100, "mask_tail": n0 + nr // 2, "mask_early": 5}.get(kind)
    if mask_from is not None:
        s[:, mask_from:] = -np.inf
    return s


def _split(s, ns):
    main = s[:, :ns * TS].reshape(s.shape[0], ns, TS)
    return main, main.max(axis=2), (s[:, ns * TS:] if s.shape[1] > ns * TS else None)


def _reference(s, ns, kk):
    """The reference's selection core, with the Pallas gather (interpret
    mode) where the reference's fused path takes it."""
    main, tmax, tail = _split(s, ns)
    c = min(ns, kk + MARGIN)
    smain = jnp.asarray(np.ascontiguousarray(s[:, :ns * TS]))
    gather = ((lambda sel: jtmf.gather_subtiles(smain, sel, TS, interpret=True))
              if jtmf.gather_supported(s.shape[0], c) else None)
    top, idx = jso._tilemax_select(jnp.asarray(main), jnp.asarray(tmax),
                                   None if tail is None else jnp.asarray(tail),
                                   s.shape[1], kk, MARGIN, gather=gather)
    return np.asarray(top), np.asarray(idx)


def _port(s, ns, kk, select=ttmk.select_topk_plain):
    main, tmax, tail = (None if a is None else torch.from_numpy(np.ascontiguousarray(a))
                        for a in _split(s, ns))
    smain = main.reshape(s.shape[0], -1)
    top, idx = select(main, tmax, tail, s.shape[1], kk, MARGIN,
                      gather=lambda sel: ttmk.gather_subtiles(smain, sel, TS))
    return top.numpy(), idx.numpy()


def _assert_bit_equal(got, ref):
    (gt, gi), (rt, ri) = got, ref
    assert gt.dtype == np.float32 and gt.shape == rt.shape
    assert np.array_equal(gt.view(np.int32), np.asarray(rt, np.float32).view(np.int32))
    assert np.array_equal(gi, np.asarray(ri, np.int64))


@pytest.mark.parametrize("kind", ["random", "ties", "tail_tie", "mask_subtile", "mask_tail",
                                  "mask_early"])
@pytest.mark.parametrize("nr", [0, 1, 576])
@pytest.mark.parametrize("kk", [1, 10, 16, 17, 40, 64, 100, 128, 129])
def test_plain_stage_matches_reference_bit_for_bit(kk, nr, kind):
    s = _scores(B, NS, nr, kind, seed=kk * 1000 + nr)
    ref = _reference(s, NS, kk)
    _assert_bit_equal(_port(s, NS, kk), ref)
    _assert_bit_equal(_port(s, NS, kk, select=ttmk.select_topk), ref)   # the CPU takes the chain


@pytest.mark.parametrize("b,ns,kk", [(8, 8, 10), (3, 1, 16), (5, 20, 16)])
def test_plain_stage_matches_reference_when_every_sub_tile_is_selected(b, ns, kk):
    """c = ns (the route never sends it; a direct call may)."""
    s = _scores(b, ns, 100, "ties", seed=ns)
    _assert_bit_equal(_port(s, ns, kk), _reference(s, ns, kk))


def _stage_by_keys(s, ns, kk, margin=MARGIN):
    """What the kernel computes, in numpy: the best c sub-tiles by the key of
    (maximum, sub-tile id), their ids ascending, then the best kk
    candidates by the key of (score, global id), read back by position."""
    b, n = s.shape
    main, tmax, _ = _split(s, ns)
    c = min(ns, kk + margin)
    top, idx = np.empty((b, kk), np.float32), np.empty((b, kk), np.int64)
    for r in range(b):
        ids = np.arange(ns, dtype=np.int32)
        sel = np.sort(ids[np.argsort(~tsf.order_keys(tmax[r], ids), kind="stable")[:c]])
        gid = np.concatenate([(sel[:, None] * TS + np.arange(TS)).ravel(),
                              np.arange(ns * TS, n)]).astype(np.int32)
        vals = s[r, gid]
        best = np.argsort(~tsf.order_keys(vals, gid), kind="stable")[:kk]
        top[r], idx[r] = vals[best], gid[best]
    return top, idx


FLOATS = st.sampled_from([0.0, -0.0, 1.0, -1.0, 0.5, float("-inf"), float("inf"), float("nan"),
                          -3.0e38, 1e-45])


@settings(max_examples=200, deadline=None, database=None)
@given(st.integers(1, 24), st.lists(FLOATS, min_size=24, max_size=24), st.data())
def test_best_subtiles_by_key_are_topk_stable_then_the_id_sort(c, maxima, data):
    """The kernel's selection rule: the best c of (maximum, sub-tile id)
    under ``order_keys`` (ties by position) are ``topk_stable``'s c ids,
    sorted — with ±0.0, ±inf and NaN maxima."""
    ns = data.draw(st.integers(c, 24))
    m = np.asarray(maxima[:ns], np.float32)
    ids = np.arange(ns, dtype=np.int32)
    by_key = np.sort(ids[np.argsort(~tsf.order_keys(m, ids), kind="stable")[:c]])
    _, sel = tso.topk_stable(torch.from_numpy(m)[None], c)
    assert by_key.tolist() == torch.sort(sel, dim=1).values[0].tolist()


@settings(max_examples=60, deadline=None, database=None)
@given(st.integers(1, 16), st.integers(0, 300), st.sampled_from(["random", "ties", "zeros", "nan"]),
       st.integers(0, 2**32 - 1))
def test_key_ranking_is_the_chain_bit_for_bit(kk, nr, kind, seed):
    """The whole stage ranked by keys (as the kernel ranks) equals the
    chain bit for bit, NaN and ±0.0 scores included."""
    rng = np.random.default_rng(seed)
    ns = 10
    s = _scores(2, ns, nr, "ties" if kind == "ties" else "random", seed)
    if kind == "zeros":
        s = np.where(rng.random(s.shape) < 0.5, np.float32(-0.0), np.float32(0.0))
    elif kind == "nan":
        s[rng.random(s.shape) < 0.01] = np.nan
    _assert_bit_equal(_stage_by_keys(s, ns, kk), _port(s, ns, kk))


def _radix_kth(keys, k, lo):
    """``radix_kth`` of ``csrc/tilemax.cu``: the k-th best of the keys ≥
    ``lo``, 8-bit digits from the top, a histogram a round of the keys that
    share the digits found so far; a round whose digit holds nothing beyond
    the k-th key ends the search. Returns the threshold from which exactly
    k keys are ≥ ``lo`` and ≥ it."""
    prefix, need = np.uint64(0), k
    for shift in range(56, -8, -8):
        hi = np.uint64(0) if shift == 56 else np.uint64((2**64 - 1) << (shift + 8) & (2**64 - 1))
        live = keys[(keys >= lo) & ((keys & hi) == prefix)]
        hist = np.bincount(((live >> np.uint64(shift)) & np.uint64(255)).astype(np.int64), minlength=256)
        above = 0
        for d in range(255, -1, -1):
            if above + hist[d] >= need:
                break
            above += hist[d]
        prefix |= np.uint64(d) << np.uint64(shift)
        need -= above
        if hist[d] == need:
            break
    return max(prefix, lo)


def _thread_bests(keys, threads, unit):
    """Thread t's best key of its units of ``unit`` positions t, t +
    threads, ... (0 where it has none)."""
    bests = np.zeros(threads, np.uint64)
    np.maximum.at(bests, (np.arange(len(keys)) // unit) % threads, keys)
    return bests


def _select_best(keys, k, cap, hint=0, threads=ttmk.WIDE_THREADS):
    """``select_best`` and ``rank_best`` of ``csrc/tilemax.cu`` on distinct
    uint64 keys: the keys that reach ``hint`` (0: none) are listed; where
    fewer than k or more than ``cap`` do, the k-th best of the thread
    bests (thread t: units of 4 positions t, t + threads, ...) is the bar
    instead if it is the higher; where more than ``cap`` reach the bar, the
    keys from the radix select's threshold (exactly k); the listed keys
    ranked. Returns the best k positions in key order and which bar listed
    them."""
    bar, path = np.uint64(hint), "hint"
    m = int((keys >= bar).sum()) if hint else 0
    if m < k or m > cap:
        own = np.sort(_thread_bests(keys, threads, 4))[::-1][k - 1]
        if m < k or own > bar:
            bar, path = own, "bar"
    listed = np.flatnonzero(keys >= bar)
    assert len(listed) >= k
    if len(listed) > cap:
        listed, path = np.flatnonzero(keys >= _radix_kth(keys, k, bar)), "radix"
        assert len(listed) == k
    return listed[np.argsort(~keys[listed])][:k], path


def _wide_stage_model(s, ns, kk, cap=ttmk.WIDE_CAP, margin=MARGIN, tmax=None):
    """The wide kernel's two selections in numpy: the c best sub-tiles by
    (maximum, sub-tile id), their ids ascending; the best kk candidates by
    (score, global id), the c-th best maximum's score (any id) the bar
    tried first, read back by position. Returns ``((top, idx), paths)``,
    the set of bars that listed them."""
    b, n = s.shape
    if tmax is None:
        tmax = _split(s, ns)[1]
    c = min(ns, kk + margin)
    top, idx = np.empty((b, kk), np.float32), np.empty((b, kk), np.int64)
    paths = set()
    for r in range(b):
        ids = np.arange(ns, dtype=np.int32)
        max_keys = tsf.order_keys(tmax[r], ids)
        best_c, p1 = _select_best(max_keys, c, cap)
        hint = max_keys[best_c[-1]] & np.uint64(0xFFFFFFFF00000000)
        sel = np.sort(best_c).astype(np.int32)
        gid = np.concatenate([(sel[:, None] * TS + np.arange(TS)).ravel(),
                              np.arange(ns * TS, n)]).astype(np.int32)
        vals = s[r, gid]
        best, p2 = _select_best(tsf.order_keys(vals, gid), kk, cap, hint)
        top[r], idx[r] = vals[best], gid[best]
        paths |= {p1, p2}
    return (top, idx), paths


def _striped(b, ns, nr, stripe, seed):
    """Scores whose large values lie only at positions p with p mod 2048 <
    4·``stripe`` (the units of a few of the 512 threads when every sub-tile
    is selected): more of them reach the thread-best bar than a list holds."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, ns * TS + nr)).astype(np.float32)
    big = (np.arange(s.shape[1]) % 2048) < 4 * stripe
    s[:, big] += np.float32(10.0)
    return s


WIDE_KINDS = ["random", "ties", "zeros", "nan", "mask", "few_finite", "striped"]


@settings(max_examples=120, deadline=None, database=None)
@given(st.integers(1, 128), st.integers(0, 40), st.sampled_from([0, 1, 576, 2047]),
       st.sampled_from(WIDE_KINDS), st.sampled_from([ttmk.WIDE_CAP, 0, 7]),
       st.integers(0, 2**32 - 1))
def test_wide_stage_model_is_the_chain_bit_for_bit(kk, extra_ns, nr, kind, cap, seed):
    """The wide kernel's selection (numpy model, the kernel's 512 threads,
    bars and digits) equals the chain bit for bit for kk 1–128: ties, NaN,
    ±0.0, −inf from a ``mask_from``, fewer than kk finite scores, and scores
    whose large values pass the bars by the thousand; with the kernel's
    list cap, and with caps of 0 and 7 that send (nearly) every selection
    through the radix select."""
    rng = np.random.default_rng(seed)
    ns = kk + MARGIN + extra_ns                       # extra_ns = 0: every sub-tile selected
    n = ns * TS + nr
    s = rng.standard_normal((2, n)).astype(np.float32)
    if kind == "ties":
        s = rng.integers(0, 3, size=s.shape).astype(np.float32)
    elif kind == "zeros":
        s = np.where(rng.random(s.shape) < 0.5, np.float32(-0.0), np.float32(0.0))
    elif kind == "nan":
        s[rng.random(s.shape) < 0.01] = np.nan
    elif kind == "mask":
        s[:, rng.integers(1, n):] = -np.inf
    elif kind == "few_finite":
        s[:, rng.integers(0, kk):] = -np.inf
    elif kind == "striped":
        s = _striped(2, ns, nr, max(1, kk - 1), seed)
    got, _ = _wide_stage_model(s, ns, kk, cap)
    _assert_bit_equal(got, _port(s, ns, kk))


@pytest.mark.parametrize("kk", [40, 100, 128])
def test_wide_stage_model_takes_the_radix_select_past_its_cap(kk):
    """With every sub-tile selected and the large scores in kk − 1 threads'
    positions, more candidates reach either bar than the list holds: the
    model goes through the radix select at the kernel's own cap and still
    equals the chain; on random scores the thread bests' bar lists the
    sub-tiles and the c-th maximum's score the candidates."""
    ns, nr = kk + MARGIN, 576
    s = _striped(2, ns, nr, kk - 1, seed=kk)
    got, paths = _wide_stage_model(s, ns, kk)
    assert "radix" in paths
    _assert_bit_equal(got, _port(s, ns, kk))
    s = _scores(2, NS, nr, "random", seed=kk)
    got, paths = _wide_stage_model(s, NS, kk)
    assert paths == {"bar", "hint"}
    _assert_bit_equal(got, _port(s, NS, kk))


@pytest.mark.parametrize("kk", [17, 100])
def test_wide_stage_model_holds_when_maxima_overstate_their_sub_tiles(kk):
    """Maxima above their sub-tiles' scores (the chain takes any maxima):
    the c-th maximum's score is then reached by fewer than kk candidates,
    and the thread bests' bar lists them instead, equal to the chain."""
    s = _scores(2, NS, 576, "random", seed=kk)
    main, tmax, tail = _split(s, NS)
    tmax = tmax + np.float32(1.0)
    got, paths = _wide_stage_model(s, NS, kk, tmax=tmax)
    assert paths == {"bar"}
    top, idx = ttmk.select_topk_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (main, tmax, tail)),
                                      s.shape[1], kk, MARGIN)
    _assert_bit_equal(got, (top.numpy(), idx.numpy()))


def test_wide_plan_fits_the_card():
    """The wide kernel's plan (the C entry's ``mrs_subtile_topk_wide_plan``,
    held equal on the card) is the model's: 512 threads a query and a list
    cap of 512; the thread-best bar's warp lists are whole warps."""
    assert ttmk.subtile_topk_wide_plan() == dict(threads=512, cap=512)
    assert ttmk.WIDE_THREADS % 32 == 0 and ttmk.WIDE_CAP >= ttmk.TOPK_MAX_K_WIDE


@settings(max_examples=150, deadline=None, database=None)
@given(st.sampled_from([(256, 1, 32), (512, 4, 132)]), st.integers(1, 3000),
       st.sampled_from(["random", "ties", "zeros", "nan"]), st.integers(0, 2**32 - 1), st.data())
def test_thread_best_bar_lets_every_one_of_the_best_k_through(design, n, kind, seed, data):
    """The kernels' filter (``take_filtered`` in ``csrc/warp_topk.cuh``: 256
    threads, positions t, t + 256, ..., k ≤ 32; ``thread_best_bar`` in
    ``csrc/tilemax.cu``: 512 threads, units of 4 positions t, t + 512, ...,
    k ≤ 132): the k-th best of the thread bests is a bar that at least
    min(k, n) candidates reach and every one of the best k does — ids
    ascending with the positions, NaN and ±0.0 scores included."""
    threads, unit, k_max = design
    k = data.draw(st.integers(1, k_max))
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n).astype(np.float32)
    if kind == "ties":
        v = rng.integers(0, 3, n).astype(np.float32)
    elif kind == "zeros":
        v = np.where(rng.random(n) < 0.5, np.float32(-0.0), np.float32(0.0))
    elif kind == "nan":
        v[rng.random(n) < 0.05] = np.nan
    ids = np.cumsum(rng.integers(1, 5, n)).astype(np.int32)
    keys = tsf.order_keys(v, ids)
    bar = np.sort(_thread_bests(keys, threads, unit))[::-1][k - 1]
    reach = keys >= bar
    assert reach.sum() >= min(k, n)
    assert reach[np.argsort(~keys, kind="stable")[:k]].all()


def test_route_takes_the_kernel_for_k_up_to_16_off_the_cpu():
    """Off the CPU the one-launch stage takes every kk ≤ 128 (warp lists up
    to 16, shared-memory lists beyond) and the chain with kernel C the
    rest; the CPU always takes the chain."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    ks = (1, 10, 16, 17, 40, 100, 128, 129, 200)
    assert [ttmk.select_route(cuda, kk) for kk in ks] == ["kernel"] * 7 + ["chain"] * 2
    assert {ttmk.select_route(cpu, kk) for kk in ks} == {"chain"}
    assert ttmk.TOPK_MAX_K == 16                   # one register lane a list entry, as kernel G's merge
    assert ttmk.TOPK_MAX_K_WIDE == 128             # lists in shared memory


def test_route_off_the_cpu_launches_or_raises_never_the_chain(monkeypatch):
    """A tensor that does not lie on the CPU (here on the meta device, with
    no card) goes to the one-launch kernel for kk ≤ 128 and to the chain
    with kernel C beyond: both are refused, nothing is computed on the CPU
    and no launch is counted."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kernels.reset_launches()
    m = dict(device="meta", dtype=torch.float32)
    main, tmax, tail = torch.empty(4, 140, TS, **m), torch.empty(4, 140, **m), torch.empty(4, 7, **m)
    smain = main.reshape(4, -1)
    for kk in (1, 16, 17, 128, 129):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttmk.select_topk(main, tmax, tail, 140 * TS + 7, kk, MARGIN,
                             gather=lambda sel: ttmk.gather_subtiles(smain, sel, TS))
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


def test_fused_tilemax_selects_through_select(monkeypatch):
    """``fused_tilemax`` hands its sub-tile view, maxima, tail, k and
    margin to ``select``, whose result it returns; the default is the
    one-launch stage's wrapper, and on the CPU its result is the chain's."""
    rng = np.random.default_rng(4)
    n, f, b = 3 * 2048 + 300, 16, 5
    X = torch.from_numpy(rng.standard_normal((n, f), dtype=np.float32))
    norms = torch.linalg.norm(X, dim=1)
    lams = torch.from_numpy(rng.random(n, dtype=np.float32))
    Q, ql = X[:b].clone(), lams[:b].clone()
    seen = []

    def spy(main, tmax, tail, n_, kk, margin, gather=None):
        seen.append((tuple(main.shape), tuple(tmax.shape), tuple(tail.shape), n_, kk, margin))
        return ttmk.select_topk(main, tmax, tail, n_, kk, margin, gather)

    got = tso.fused_tilemax(X, norms, lams, Q, ql, 10, 0.7, select=spy)
    assert seen == [((b, 24, TS), (b, 24), (b, 300), n, 10, MARGIN)]
    plain = tso.fused_tilemax(X, norms, lams, Q, ql, 10, 0.7, select=ttmk.select_topk_plain)
    default = tso.fused_tilemax(X, norms, lams, Q, ql, 10, 0.7)
    for a, c in zip(got, plain):
        assert torch.equal(a, c)
    for a, c in zip(default, plain):
        assert torch.equal(a, c)
    assert torch.equal(got[1][:, 0], torch.arange(b))      # each query finds its own row first
