"""Energy mode on the card: an energy index built on the card serves
``search_batch`` through the kernels (the exact tier: kernel B and the
candidate stage; ``bf16x3_rescored``: kernels D and E), held against the
same routes through the kernels' plain versions, and the energy scan
against the same index on the CPU. The full scan's kernel
(``ops/kernels/energy_scan.py``) against its plain version over B, N, F,
k, alignment, one λ for all, duplicate rows and the tie band's edge, and
the full scan's launches, syncs and device operations. Every test needs
a CUDA card and ``nvcc`` (marker ``gpu``) and skips without them. This
file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_energy_gpu.py

Tolerances: the exact tier under the near-tie rule at 1e-5
(``utils/parity.topk_mismatches``), the rescored tier under the same-k
rule at 1e-5; the energy scan on the card against the CPU's under the
same-k rule at 1e-14 (the tie-break term ``1e-9·(1 − cos)`` at a cosine
tolerance of 1e-5), and so the scan kernel against its plain version; a
row with no pair in the tie band bit for bit.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from matternet_rs_tpu_torch import backend, convert
from matternet_rs_tpu_torch import energymaps as tem
from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder
from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops import search as tso
from matternet_rs_tpu_torch.ops.kernels import energy_scan as esk
from matternet_rs_tpu_torch.ops.kernels import rescored as trsk
from matternet_rs_tpu_torch.ops.kernels import search_fused as tsf
from matternet_rs_tpu_torch.ops.kernels import tilemax as ttmk
from matternet_rs_tpu_torch.utils import profiling
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset
from matternet_rs_tpu_torch.utils.parity import ENERGY_TIE_TOL, same_k_mismatches, topk_mismatches

pytestmark = pytest.mark.gpu

N, F, B, K = 65_536, 128, 256, 10


@pytest.fixture(scope="module")
def energy_index():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if backend.nvcc_path() is None:
        pytest.skip("needs nvcc to build the kernels")
    data = make_energy_test_dataset(N, F, seed=43).astype(np.float32)
    b = (ArrowSpaceBuilder().with_lambda_graph(1.0, 6).with_sparsity_check(False)
         .with_cluster_params(max_clusters=64, radius=25.0).with_sampling(None)
         .with_expected_items(N).with_dims_reduction(True))
    aspace, gl = b.build_energy(data)
    Q = data[np.random.default_rng(3).choice(N, B, replace=False)]
    return data, aspace, gl, Q


def _batch(aspace, Q):
    dev = aspace.device
    Qt = torch.from_numpy(Q).to(dev)
    ql = aspace._nearest_subcentroid_lambdas(aspace._energy_query(Qt))
    return Qt, ql, torch.full((len(Q),), 0.7, dtype=torch.float32, device=dev)


def test_energy_exact_tier_runs_kernel_b_and_the_stage(energy_index):
    _, aspace, gl, Q = energy_index
    kernels.reset_launches()
    idx, sc, raw = aspace.search_batch(Q, gl, K, return_raw=True)
    counts = kernels.launch_counts()
    assert counts["scores_tilemax"] == 1 and counts["subtile_topk"] == 1, counts
    Qt, ql, al = _batch(aspace, Q)
    assert np.array_equal(raw, ql.cpu().numpy())
    top_p, idx_p = tso.fused_tilemax(
        aspace.data, aspace.norms, aspace.lambdas, Qt, ql, K + 1, al, tso.DEFAULT_TILE,
        producer=ttmk.scores_and_tilemax_plain, gather=ttmk.gather_subtiles_plain,
        select=ttmk.select_topk_plain)
    assert not topk_mismatches(idx_p.cpu().numpy(), top_p.cpu().numpy(), idx, sc, 1e-5)


def test_energy_bf16x3_tier_runs_kernels_d_and_e(energy_index):
    _, aspace, gl, Q = energy_index
    kernels.reset_launches()
    idx, sc = aspace.search_batch(Q, gl, K, quantized="bf16x3_rescored")
    counts = kernels.launch_counts()
    assert counts["tilemax_only"] == 1 and counts["slab_dots"] == 1, counts
    Qt, ql, al = _batch(aspace, Q)
    X = aspace.data
    pidx, ptop = tso.fused_scan_rescored(
        X, X, aspace.norms, aspace.lambdas, Qt, ql, K, aspace._int8_cand(K, None), al,
        producer=trsk.tilemax_only_plain, slab_reader=trsk.slab_dots_plain)
    assert not same_k_mismatches(pidx.cpu().numpy(), ptop.cpu().numpy(), idx, sc, 1e-5)


@pytest.mark.parametrize("candidates", [None, "auto", 2000])
def test_energy_scan_on_the_card_matches_the_cpu(energy_index, candidates):
    _, aspace, gl, Q = energy_index
    p = aspace.projection
    ca, cg = convert.arrowspace_from_arrays(
        aspace.data.cpu().numpy(), aspace.lambdas.cpu().numpy(), gl.matrix.cpu().numpy(),
        min_lambdas=aspace.min_lambdas, max_lambdas=aspace.max_lambdas,
        range_lambdas=aspace.range_lambdas,
        projection=None if p is None else (p.original_dim, p.reduced_dim, p.seed),
        sub_centroids=aspace.sub_centroids.cpu().numpy(),
        subcentroid_lambdas=aspace.subcentroid_lambdas, centroid_map=aspace.centroid_map,
        item_norms=aspace.item_norms.cpu().numpy(), device="cpu")
    Qs = Q[:32]
    gi, gd = tem.search_energy_batch(aspace, Qs, gl, K, candidates=candidates)
    ri, rd = tem.search_energy_batch(ca, Qs, cg, K, candidates=candidates)
    assert not same_k_mismatches(ri, rd, gi, gd, ENERGY_TIE_TOL)


def test_argmin_and_argmax_take_the_first_index_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    big = torch.zeros(3, 70_000, device="cuda")
    big[:, 5] = big[:, 40_000] = -1.0
    assert torch.argmin(big, dim=1).tolist() == [5, 5, 5]
    assert torch.argmax(-big, dim=1).tolist() == [5, 5, 5]
    assert torch.argmin(torch.zeros(2, 300, device="cuda"), dim=1).tolist() == [0, 0]


# -- the energy full scan's kernel (ops/kernels/energy_scan.py) ---------------


def _scan_case(n, f, b, kind, seed, misalign):
    """Raw rows, their norms and λ, queries and their λ on the card.
    ``groups``: five λ values, the queries on them (|Δλ| exactly 0 for a
    whole group); ``one_lambda``: every row and query on one λ;
    ``duplicates``: groups, with forty copies of row 7 (and its λ) and
    query 0 on it; ``edge``: λ at and around 1e-9 from the queries'.
    ``misalign`` puts X 4 bytes off a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f), dtype=np.float32)
    Q = rng.standard_normal((b, f), dtype=np.float32)
    lam = rng.random(n, dtype=np.float32)
    ql = rng.random(b, dtype=np.float32)
    if kind in ("groups", "duplicates"):
        levels = np.float32([0.0, 0.125, 0.3, 0.55, 1.0])
        lam, ql = levels[rng.integers(0, 5, n)], levels[rng.integers(0, 5, b)]
    elif kind == "one_lambda":
        lam[:], ql[:] = 0.4, 0.4
    elif kind == "edge":
        eps = np.float32(1e-9)
        steps = np.float32([0, eps, np.nextafter(eps, 0), np.nextafter(eps, 1), 2 * eps, eps / 2])
        lam, ql[:] = steps[rng.integers(0, len(steps), n)], 0.0
    if kind == "duplicates":
        X[100:140], lam[100:140] = X[7], lam[7]
        Q[0], ql[0] = X[7], lam[7]
    Xt = torch.from_numpy(X).cuda()
    if misalign:
        Xt = torch.empty(n * f + 1, device="cuda")[1:].view(n, f).copy_(Xt)
    norms = torch.sqrt(torch.sum(Xt * Xt, dim=1))
    return [Xt, norms, torch.from_numpy(lam).cuda(), torch.from_numpy(Q).cuda(),
            torch.from_numpy(ql).cuda()]


@pytest.mark.parametrize("b,n,f,k,kind,misalign", [
    (1, 1, 128, 1, "random", False),
    (7, 3001, 96, 10, "groups", False),
    (256, 1_000_000, 128, 10, "groups", False),
    (7, 2777, 130, 16, "one_lambda", False),
    (256, 40_000, 1, 16, "duplicates", False),
    (7, 5000, 128, 10, "duplicates", True),
    (1, 70_001, 96, 1, "edge", False),
    (256, 65_536, 128, 16, "random", False),
    (7, 9000, 130, 10, "random", True),
])
def test_energy_scan_kernel_matches_plain(b, n, f, k, kind, misalign):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrs = _scan_case(n, f, b, kind, n + b, misalign)
    X, Q = arrs[0], arrs[3]
    splits = min(tsf.default_splits(n, b, X.device), -(-n // tsf.TILE_ROWS))
    assert tsf.scan_plan_chosen(X, Q, k, splits) == tsf.scan_plan(X, Q, splits)
    assert tsf.scan_plan(X, Q, splits)["vec"] == int(f % 4 == 0 and not misalign)
    pi, pd = esk.energy_topk_plain(*arrs, k)
    before = kernels.launch_counts()
    gi, gd = esk.energy_topk(*arrs, k)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["energy_scan"] == before["energy_scan"] + 1
    assert after["search_fused_merge"] == before["search_fused_merge"] + 1
    assert gi.dtype == torch.int64 and gi.shape == pi.shape == (b, k)
    pi, pd, gi, gd = (t.cpu().numpy() for t in (pi, pd, gi, gd))
    assert not same_k_mismatches(pi, pd, gi, gd, ENERGY_TIE_TOL)
    assert np.all(np.diff(gd, axis=1) >= 0)
    same = np.diff(gd, axis=1) == 0              # equal distances come lowest id first
    assert np.all(np.diff(gi, axis=1)[same] > 0)
    # A row with no pair in the tie band (every distance ≥ 3e-9 > d + 2e-9
    # of any band pair) holds exact |Δλ| only: bit for bit the plain one.
    out = np.all(pd >= 3e-9, axis=1)
    assert np.array_equal(gi[out], pi[out]) and np.array_equal(gd[out].view(np.int32),
                                                               pd[out].view(np.int32))
    if kind == "random" and n > 1000:
        assert out.mean() > 0.9
    qn = esk.query_norms(Q)
    for s in (1, 7):                             # the order is total: ranges change nothing
        si, sneg = tsf.merge_partials(*esk.scan_partials(*arrs[:4], qn, arrs[4], k, s), k)
        assert np.array_equal(si.long().cpu().numpy(), gi)
        assert np.array_equal((-sneg).cpu().numpy().view(np.int32), gd.view(np.int32))



@pytest.mark.parametrize("f,misalign", [(128, False), (96, False), (130, True)])
def test_energy_scan_bits_do_not_depend_on_splits_or_batch_tiling(f, misalign):
    """The energy scan and its merge: one query's distances and ids are the
    same bits for 1 range, 7 ranges and the default number, wherever the
    query sits in the batch (alone, rows 63, 64 and 65, inside batches of
    256 and 1024), with pairs in the tie band (the cosine's division)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    X, norms, lam, Q, ql = _scan_case(30_000, f, 1024, "groups", 31, misalign)
    qn = esk.query_norms(Q)
    ref = None
    for b, at in [(1, 0), (66, 63), (66, 64), (66, 65), (256, 200), (1024, 1000)]:
        def rows(t):
            batch = t[:b].clone()
            batch[at] = t[9]
            return batch.contiguous()
        for splits in (1, 7, tsf.default_splits(30_000, b, X.device)):
            ids, neg = tsf.merge_partials(*esk.scan_partials(X, norms, lam, rows(Q), rows(qn), rows(ql),
                                                             K, splits), K)
            got = (ids[at].clone(), neg[at].contiguous().view(torch.int32))
            if ref is None:
                ref = got
                band = float((-neg[at]).max()) < 1e-9   # the whole top-K ranked by the cosine
                assert band
            else:
                assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (b, at, splits)


def test_energy_scan_kernel_refuses_k_above_16():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrs = _scan_case(3000, 64, 4, "groups", 1, False)
    with pytest.raises(ValueError, match="k=17"):
        esk.energy_topk(*arrs, 17)


@pytest.mark.parametrize("k", [K, 17])
def test_energy_full_scan_is_one_scan_and_one_merge_with_no_sync_and_no_sort(energy_index,
                                                                             monkeypatch, k):
    """``search_energy_batch``'s full scan at k ≤ 16: one ``energy_scan``
    and one ``search_fused_merge`` launch a batch and nothing else
    counted, no call that waits for the card inside the kernel route
    (``set_sync_debug_mode("error")``), no sort kernel on the card, and
    ``route="kernel"`` on the ``search.scan`` span. At k = 17 the plain
    version, and no launch."""

    _, aspace, gl, Q = energy_index
    want_i, want_d = tem.search_energy_batch(aspace, Q, gl, k)       # first use's copies
    topk = esk.energy_topk

    def without_sync(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return topk(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(esk, "energy_topk", without_sync)
    torch.cuda.synchronize()
    kernels.reset_launches()
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gi, gd = tem.search_energy_batch(aspace, Q, gl, k)
    counts = kernels.launch_counts()
    kernel = k <= esk.K_MAX
    assert counts == {name: int(kernel and name in ("energy_scan", "search_fused_merge"))
                      for name in kernels.LAUNCHES}, counts
    route = [s.attrs for s in profiling.spans() if s.name == "search.scan"]
    assert route == [{"route": "kernel" if kernel else "plain"}]
    device_ops = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert device_ops
    sorts = [name for name in device_ops if "sort" in name.lower()]
    assert (not sorts) if kernel else sorts, sorts[:3]
    assert np.array_equal(gi, want_i) and np.array_equal(gd.view(np.int32), want_d.view(np.int32))
