"""The energy full scan's kernel route (``ops/kernels/energy_scan.py``), on
the CPU: the plain version is the scan as ``energymaps`` wrote it before
the kernel (the ``[B, N]`` scores, then ``topk_stable``) bit for bit; the
window rule (the band's k first, then the walks) is the full scan bit for
bit on every corpus, and each corpus reaches its case; the
merge kernel's 64-bit keys of −s (``search_fused.order_keys``), taken per
N-range and merged as the kernels take them, give ``topk_stable``'s order
on tied λ groups, duplicate rows, ``|Δλ|`` exactly 0, the tie band's edge
and ±0.0; the route is the kernel on a CUDA device for 1 ≤ k ≤ 16 only,
the window where a current sorted view lies on the card; without a card
both kernels are refused and nothing is counted. The card's
side is ``test_torch_energy_gpu.py``."""

import numpy as np
import pytest
import torch

from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops.kernels import energy_scan as esk
from matternet_rs_tpu_torch.ops.kernels import search_fused as sfk
from matternet_rs_tpu_torch.ops.search import topk_stable


def _before_kernel(X, norms, lambdas, Q, q_lams, k):
    """``search_energy_batch``'s full scan as written before the kernel."""
    lam_dist = torch.abs(q_lams[:, None] - lambdas[None, :])
    qn = torch.sqrt(torch.sum(Q * Q, dim=-1))
    cosine = torch.matmul(Q, X.T) / (qn[:, None] * norms[None, :] + 1e-9)
    scores = lam_dist + torch.where(lam_dist < 1e-9, (1.0 - cosine) * 1e-9,
                                    torch.zeros_like(cosine))
    neg, idx = topk_stable(-scores, k)
    return idx, -neg


def _corpus(n, f, b, seed, kind="random"):
    """Raw rows, their norms and λ, queries and their λ. ``groups``: five
    λ values, each query on one of them (|Δλ| exactly 0 for a whole
    group); ``one_lambda``: every row and query on one λ; ``duplicates``:
    groups, with forty copies of row 7 and of its λ where N > 140; ``edge``: λ at and
    around 1e-9 from the queries' (the tie band's edge). For the window
    rule: ``small_band``: distinct λ, each query's shared by three rows
    (a band of fewer than k); ``near_zero``: distinct λ within 1e-9 of each
    other near 0, every query its own band; ``under_kth``: half the rows on
    the queries' λ and pointing away from them, the rest 1.1–5e-9 from
    it, under the band's k-th score; ``both_sides``: λ at 0.25 ± j·2⁻²⁴, equal distances on both
    sides of the queries' 0.25, which no row has; ``absent``: five λ
    values, the queries between them (an empty band); ``merged_d``: distinct
    λ below 3e-7 and queries at 1, so that ``1 − λ`` rounds many λ to one
    distance, their ids out of order along the sorted λ."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    Q = rng.normal(size=(b, f)).astype(np.float32)
    lam = rng.random(n).astype(np.float32)
    ql = rng.random(b).astype(np.float32)
    if kind in ("groups", "duplicates"):
        levels = np.float32([0.0, 0.125, 0.3, 0.55, 1.0])
        lam = levels[rng.integers(0, 5, n)]
        ql = levels[rng.integers(0, 5, b)]
    elif kind == "one_lambda":
        lam[:] = 0.4
        ql[:] = 0.4
    elif kind == "edge":
        eps = np.float32(1e-9)
        steps = np.float32([0, eps, np.nextafter(eps, 0), np.nextafter(eps, 1), 2 * eps,
                            eps / 2])
        ql[:] = 0.0
        lam = steps[rng.integers(0, len(steps), n)]
    elif kind == "small_band":
        ql = lam[rng.choice(n, b, replace=False)]
        for r, v in enumerate(ql):
            lam[[(3 * r + 11) % n, (3 * r + 12) % n]] = v
    elif kind == "near_zero":
        lam = (rng.integers(0, 30, n) * 1e-10).astype(np.float32)
        ql = (rng.integers(0, 30, b) * 1e-10).astype(np.float32)
    elif kind == "under_kth":
        ql[:] = 1e-8
        off = np.float32([0, 0, 0, 0, 1.1e-9, -1.5e-9, 2.5e-9, -5e-9])
        pick = rng.integers(0, len(off), n)
        lam = np.float32(1e-8) + off[pick]
        base = rng.normal(size=f).astype(np.float32)    # band rows point away from every query
        Q = (base + 0.1 * Q).astype(np.float32)
        X[pick < 4] = -base + 0.1 * X[pick < 4]
    elif kind == "both_sides":
        ql[:] = 0.25
        lam = (0.25 + rng.choice([-3, -2, -1, 1, 2, 3], n) * 2.0**-24).astype(np.float32)
    elif kind == "absent":
        levels = np.float32([0.0, 0.125, 0.3, 0.55, 1.0])
        lam = levels[rng.integers(0, 5, n)]
        ql = np.float32([0.0625, 0.2, 0.4, 0.7])[rng.integers(0, 4, b)]
    elif kind == "merged_d":
        lam = (rng.random(n) * 3e-7).astype(np.float32)
        ql[:] = 1.0
    if kind == "duplicates" and n > 140:
        X[100:140] = X[7]
        lam[100:140] = lam[7]
        Q[0] = X[7]
        ql[0] = lam[7]
    norms = np.sqrt(np.sum(X * X, axis=1))
    return [torch.from_numpy(a) for a in (X, norms, lam, Q, ql)]


KINDS = ["random", "groups", "one_lambda", "duplicates", "edge"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,f,b,k", [(1, 4, 3, 1), (700, 1, 5, 10), (2777, 96, 7, 16),
                                     (3001, 130, 2, 40)])
def test_plain_version_is_the_scan_as_it_was(n, f, b, k, kind):
    arrs = _corpus(n, f, b, n + f, kind)
    k = min(k, n)
    want_i, want_d = _before_kernel(*arrs, k)
    for fn in (esk.energy_topk_plain, esk.energy_topk):        # the wrapper takes it on the CPU
        got_i, got_d = fn(*arrs, k)
        assert got_i.dtype == want_i.dtype == torch.int64
        assert torch.equal(got_i, want_i)
        assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))


def _by_keys(neg, k, splits):
    """What the scan and the merge keep: per N-range of whole 256-row tiles
    the best 16 by ``order_keys`` (largest first), then the best ``k`` of
    those lists, by key again."""
    b, n = neg.shape
    rows = -(-(-(-n // sfk.TILE_ROWS)) // splits) * sfk.TILE_ROWS
    out = []
    for r in range(b):
        keys = sfk.order_keys(neg[r].numpy(), np.arange(n, dtype=np.int32))
        lists = [s + np.argsort(keys[s:s + rows])[::-1][:sfk.K_PAD]
                 for s in range(0, n, rows)]
        cand = np.concatenate(lists)
        out.append(cand[np.argsort(keys[cand])[::-1][:k]])
    return torch.from_numpy(np.stack(out))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("splits", [1, 3, 7])
def test_keys_of_minus_s_give_topk_stables_order(kind, splits):
    X, norms, lam, Q, ql = _corpus(2000, 24, 6, 11, kind)
    neg = -esk.energy_scores_plain(X, norms, lam, Q, ql)
    for k in (1, 10, 16):
        _, want = topk_stable(neg, k)
        assert torch.equal(_by_keys(neg, k, splits), want)


def test_keys_hold_plus_and_minus_zero_equal():
    """Scores of +0.0 and −0.0 tie, and fall to the lowest id, under both."""
    rng = np.random.default_rng(2)
    s = np.where(rng.random((3, 600)) < 0.5, np.float32(0.0), np.float32(-0.0))
    s[:, ::7] = np.float32(1e-12)
    neg = -torch.from_numpy(s)
    for k in (1, 10, 16):
        _, want = topk_stable(neg, k)
        assert torch.equal(_by_keys(neg, k, 1), want)
        assert torch.equal(_by_keys(neg, k, 2), want)


WINDOW_KINDS = KINDS + ["small_band", "near_zero", "under_kth", "both_sides", "absent",
                       "merged_d"]


def _sorted(lam):
    return torch.sort(lam, stable=True)


@pytest.mark.parametrize("kind", WINDOW_KINDS)
@pytest.mark.parametrize("n,f,b", [(1000, 16, 7), (2777, 24, 5)])
@pytest.mark.parametrize("k", [1, 10, 16])
def test_window_rule_is_the_full_scan(n, f, b, k, kind):
    """The window rule (the band's k first, then the walks out of it) gives
    the full scan's ids and distances bit for bit; on the CPU the wrapper
    takes the plain rule. N is not a multiple of 256."""
    X, norms, lam, Q, ql = _corpus(n, f, b, n + f + k, kind)
    want_i, want_d = esk.energy_topk_plain(X, norms, lam, Q, ql, k)
    for fn in (esk.energy_topk_window_plain, esk.energy_topk_window):
        got_i, got_d = fn(X, norms, *_sorted(lam), Q, ql, k)
        assert got_i.dtype == torch.int64 and got_d.dtype == torch.float32
        assert torch.equal(got_i, want_i)
        assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))


@pytest.mark.parametrize("kind,case", [
    ("small_band", "band under k"), ("near_zero", "bands differ"), ("under_kth", "past the band"),
    ("both_sides", "equal d both sides"), ("absent", "empty band"), ("edge", "the band's edge"),
    ("merged_d", "one d, several λ"),
])
def test_window_corpora_reach_their_case(kind, case):
    """Each corpus of the window tests reaches what it is there for, at k =
    10: a band of fewer than k rows, bands that differ from query to
    query, rows outside the band in the answer, an answer that holds equal
    distances from both sides of the query's λ, an empty band, a band
    whose last row lies one float below 1e-9 with a row at 1e-9 beside it,
    an answer whose equal distances come from distinct λ with ids out of
    their sorted order."""
    k = 10
    X, norms, lam, Q, ql = _corpus(1000, 16, 7, 7, kind)
    s_lam, s_idx = _sorted(lam)
    bands = [esk._band(s_lam, ql[q])[:2] for q in range(len(ql))]
    idx, _ = esk.energy_topk_plain(X, norms, lam, Q, ql, k)
    outside = [set(idx[q].tolist()) - set(s_idx[lo:hi].tolist()) for q, (lo, hi) in enumerate(bands)]
    if case == "band under k":
        assert all(0 < hi - lo < k for lo, hi in bands)
    elif case == "bands differ":
        assert len(set(bands)) > 1 and all(hi > lo for lo, hi in bands)
    elif case == "past the band":
        assert all(hi - lo >= k for lo, hi in bands) and any(outside)
    elif case == "equal d both sides":
        d = torch.abs(ql[0] - lam[idx[0]])
        assert bool(torch.any((lam[idx[0]] < ql[0]) & (d == d.max())))
        assert bool(torch.any((lam[idx[0]] > ql[0]) & (d == d.max())))
    elif case == "empty band":
        assert all(hi == lo for lo, hi in bands)
    elif case == "one d, several λ":
        d = torch.abs(ql[0] - lam[idx[0]])
        tied = idx[0][d == d[0]]
        assert len(set(lam[tied].tolist())) > 1 and all(hi == lo for lo, hi in bands)
        pos = torch.argsort(s_idx)[tied]             # sorted positions of the tied answer
        assert not bool(torch.all(pos[1:] > pos[:-1]))
    else:
        eps = np.float32(1e-9)
        lo, hi = bands[0]
        assert float(s_lam[hi - 1]) == np.nextafter(eps, np.float32(0)) and float(s_lam[hi]) == eps


@pytest.mark.parametrize("k,device,window,route", [
    (1, "cuda", True, "window"), (10, "cuda", True, "window"), (16, "cuda", True, "window"),
    (10, "cuda", False, "kernel"), (17, "cuda", True, "plain"), (0, "cuda", True, "plain"),
    (10, "cpu", True, "plain"),
])
def test_window_route_needs_a_card_and_a_view(k, device, window, route):
    assert esk.route(torch.device(device), k, window=window) == route


def test_window_view_is_the_current_lambdas_on_a_card():
    """The route takes the sorted view only where it was sorted from the
    space's current λ tensor and lies on a card; a host index, a view on
    the CPU and a view of replaced λ give none."""
    from types import SimpleNamespace

    from matternet_rs_tpu_torch import energymaps as tem
    from matternet_rs_tpu_torch.index.sorted import DeviceSortedLambdas, SortedLambdas

    lam = torch.rand(300)
    view = DeviceSortedLambdas.build_from(lam)
    assert view.source is lam
    assert torch.equal(view.sorted_indices_dev, torch.sort(lam, stable=True)[1])
    space = SimpleNamespace(lambdas=lam, lambdas_sorted=view)
    assert tem._window_view(space) is None                       # on the CPU
    space.lambdas_sorted = SortedLambdas.build_from(lam.numpy())
    assert tem._window_view(space) is None
    space.lambdas_sorted = DeviceSortedLambdas(view.sorted_lambdas_dev.to("meta"),
                                               view.sorted_indices_dev.to("meta"), 0.0, source=lam)
    assert tem._window_view(space) is None                       # not a CUDA device
    space.lambdas = lam.clone()
    assert tem._window_view(space) is None                       # λ replaced


@pytest.mark.parametrize("k,device,route", [
    (1, "cuda", "kernel"), (10, "cuda", "kernel"), (16, "cuda", "kernel"),
    (17, "cuda", "plain"), (0, "cuda", "plain"), (10, "cpu", "plain"), (16, "cpu", "plain"),
])
def test_route_rests_on_the_device_and_k(k, device, route):
    assert esk.route(torch.device(device), k) == route
    assert esk.route(device, k) == route


def test_plan_mirror():
    X = torch.zeros(1000, 128)
    p = sfk.scan_plan(X, torch.zeros(256, 128), 132)
    assert p == dict(vec=int(X.data_ptr() % 16 == 0), tiles_per_split=1, blocks=4 * 132)
    assert sfk.scan_plan(torch.zeros(10_000, 130), torch.zeros(7, 130), 33) == dict(
        vec=0, tiles_per_split=2, blocks=33)


def test_kernel_is_refused_without_a_card():
    """A tensor that does not lie on the CPU (the meta device) sends the
    wrapper to the kernel, which is refused; no launch is counted."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the kernel takes it")
    kernels.reset_launches()
    m = dict(device="meta", dtype=torch.float32)
    arrs = (torch.empty(4096, 8, **m), torch.empty(4096, **m), torch.empty(4096, **m),
            torch.empty(4, 8, **m), torch.empty(4, **m))
    for splits in (1, 7):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            esk.scan_partials(*arrs[:4], torch.empty(4, **m), arrs[4], 10, splits)
    with pytest.raises(ValueError, match="k=17"):
        esk.energy_topk(*arrs, 17)
    s_idx = torch.empty(4096, device="meta", dtype=torch.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        esk.energy_topk_window(arrs[0], arrs[1], arrs[2], s_idx, arrs[3], arrs[4], 10)
    with pytest.raises(ValueError, match="k=17"):
        esk.energy_topk_window(arrs[0], arrs[1], arrs[2], s_idx, arrs[3], arrs[4], 17)
    assert kernels.launch_counts() == {name: 0 for name in kernels.LAUNCHES}


def test_tally_keeps_its_four_words_and_adds_the_narrow_dot_pairs():
    """The tally's order is the C kernels' word order: the first four words
    as before, the narrow tiles' dot pairs appended."""
    assert esk.TALLY_NAMES[:4] == ("band_pairs", "dot_pairs", "queries_past_band", "rows_walked")
    assert esk.TALLY_NAMES[4:] == ("narrow_dot_pairs",)


def _levels_plan(per_level, rows, narrow_w, extra=()):
    """The plan's mirror on λ in levels 1, 2, ... with ``rows[i]`` rows on
    level i + 1 and ``per_level[i]`` queries on it, then ``extra`` query λ."""
    lam = torch.cat([torch.full((r,), float(i + 1)) for i, r in enumerate(rows)])
    ql = torch.tensor([float(i + 1) for i, c in enumerate(per_level) for _ in range(c)]
                      + list(extra))
    return esk.window_plan_plain(torch.sort(lam, stable=True)[0], ql, narrow_w)


@pytest.mark.parametrize("narrow_w", [4, 8, 16])
@pytest.mark.parametrize("extra", [0, 1, 57])
def test_window_plan_takes_a_band_of_at_most_w_queries_narrow(narrow_w, extra):
    """A band of W queries is one narrow group (W slots × its tiles), one
    of W + 1 or more queries groups of 64 (64 slots × its tiles each)."""
    n = narrow_w + extra
    rows = [700, 1500, 300]                   # 3, 6 and 2 tiles
    plan = _levels_plan([n, 0, 1], rows, narrow_w)
    band = n * 700 + 300
    narrow = 2 * narrow_w * 256 + (3 * narrow_w * 256 if extra == 0 else 0)
    wide = 0 if extra == 0 else -(-n // 64) * 3 * 64 * 256
    assert plan == dict(band_pairs=band, dot_pairs=narrow + wide, narrow_dot_pairs=narrow)


def test_window_plan_without_narrow_tiles_is_the_earlier_design():
    """At a narrow width of 0 every group is 64 wide, as before narrow tiles."""
    plan = _levels_plan([1, 0, 2], [700, 1500, 300], 0)
    assert plan == dict(band_pairs=700 + 600, dot_pairs=(3 + 2) * 64 * 256, narrow_dot_pairs=0)


def test_window_plan_puts_many_single_query_bands_on_narrow_tiles():
    """220 bands of one query each, levels between them with no query: the
    band cut (220 narrow groups) has fewer tiles than the union of
    consecutive 64s, which spans the empty levels."""
    per_level = [1, 0] * 220
    rows = [300 if c else 1500 for c in per_level]
    plan = _levels_plan(per_level, rows, 8)
    assert plan == dict(band_pairs=220 * 300, dot_pairs=220 * 2 * 8 * 256,
                        narrow_dot_pairs=220 * 2 * 8 * 256)


def test_window_plan_takes_the_union_cut_where_it_has_fewer_tiles():
    """Bands of 100 rows, one query each and side by side: 64 of them are
    64 tiles on their own and 25 as one union, which the plan takes (all
    wide); NaN query λ and empty bands count nothing."""
    plan = _levels_plan([1] * 64, [100] * 64, 8, extra=(float("nan"), 0.5, 99.0))
    assert plan == dict(band_pairs=6400, dot_pairs=25 * 64 * 256, narrow_dot_pairs=0)


def test_window_plan_sums_the_calls_of_1024_queries():
    """Past 1,024 queries the route makes one call per 1,024, each with its
    own plan: 1,030 queries on one band are 16 full groups of 64 and, in
    the second call, one narrow group of 6."""
    lam = torch.sort(torch.cat([torch.full((700,), 1.0), torch.full((300,), 2.0)]))[0]
    plan = esk.window_plan_plain(lam, torch.ones(1030), 8)
    assert plan == dict(band_pairs=1030 * 700, dot_pairs=16 * 3 * 64 * 256 + 3 * 8 * 256,
                        narrow_dot_pairs=3 * 8 * 256)
    parts = [esk.window_plan_plain(lam, q, 8) for q in (torch.ones(1024), torch.ones(6))]
    assert plan == {name: sum(p[name] for p in parts) for name in plan}
