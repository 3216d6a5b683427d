"""The energy full scan's kernel route (``ops/kernels/energy_scan.py``), on
the CPU: the plain version is the scan as ``energymaps`` wrote it before
the kernel (the ``[B, N]`` scores, then ``topk_stable``) bit for bit; the
merge kernel's 64-bit keys of −s (``search_fused.order_keys``), taken per
N-range and merged as the kernels take them, give ``topk_stable``'s order
on tied λ groups, duplicate rows, ``|Δλ|`` exactly 0, the tie band's edge
and ±0.0; the route is the kernel on a CUDA device for 1 ≤ k ≤ 16 only;
without a card the kernel is refused and nothing is counted. The card's
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
    around 1e-9 from the queries' (the tie band's edge)."""
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
    assert kernels.launch_counts() == {name: 0 for name in kernels.LAUNCHES}
