"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card (marker ``gpu``) and skips without
one. This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: λ |Δ| ≤ 1e-5·max(1, |λ|); scores and maxima ≤ 1e-5 abs (the
kernels sum the dot products in another order than cuBLAS); the gather
and the one-launch candidate stage bit for bit (values and ids); slab dots ≤ 1e-5·‖q‖·‖x‖; routed results under the same-k
rule of ``utils/parity.same_k_mismatches``; the ELL product ≤
1e-5·Σ_s|w|·|x| (it sums in the plain version's order, so it is in fact
equal), and bit for bit at the edge shapes; the streamed top-k's ids under
the near-tie rule, scores ≤ 1e-5.
"""

import numpy as np
import pytest
import torch

from matternet_rs_tpu_torch.core import quantize_rows
from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops import laplacian as tlap
from matternet_rs_tpu_torch.ops import search as tso
from matternet_rs_tpu_torch.ops import taumode as ttm
from matternet_rs_tpu_torch.ops import csr as tcsr
from matternet_rs_tpu_torch.ops import eigensolver as teig
from matternet_rs_tpu_torch.ops.kernels import rescored as trsk
from matternet_rs_tpu_torch.ops.kernels import search_fused as tsf
from matternet_rs_tpu_torch.ops.kernels import spmv_ell as tfk
from matternet_rs_tpu_torch.ops.kernels import taumode as ttk
from matternet_rs_tpu_torch.ops.kernels import tilemax as ttmk
from matternet_rs_tpu_torch.utils.parity import same_k_mismatches, topk_mismatches

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _laplacian(f, seed, device):
    if f == 1:                            # a graph needs two nodes; one feature takes L = [[0.7]]
        return torch.full((1, 1), 0.7, device=device)
    nodes = np.random.default_rng(seed).normal(size=(f, 30)).astype(np.float32)
    gl = tlap.build_laplacian_matrix(
        torch.from_numpy(nodes).to(device),
        GraphParams(eps=0.9, k=5, topk=5, sparsity_check=False),
    )
    return gl.matrix.contiguous()


@pytest.mark.parametrize("n,f,aligned", [
    (1000, 24, True), (777, 128, True), (300, 768, True), (65, 2048, True),
    (500, 1, True), (300, 130, True), (65, 2047, True),
    (777, 128, False), (1000, 3, False),              # X off 16 bytes / rows off 16 bytes
])
def test_taumode_kernel_matches_plain(cuda_device, n, f, aligned):
    L = _laplacian(f, 6, cuda_device)
    X = np.random.default_rng(7).normal(size=(n, f)).astype(np.float32)
    X[3] = 0.0
    X[5] = 1e-11
    X = torch.from_numpy(X).to(cuda_device)
    if not aligned:
        X = _misaligned(X)
    tau = ttm.select_tau(X, ttm.TAU_MEDIAN)
    before = kernels.launch_counts()["taumode"]
    got = ttk.taumode_lambdas_fused(X, L, tau)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["taumode"] == before + 1
    ref = ttk.taumode_lambdas_plain(X, L, tau)
    assert bool(torch.all((got - ref).abs() <= 1e-5 * torch.clamp(ref.abs(), min=1.0)))
    mirror = ttk.taumode_lambdas_3xtf32_plain(X, L, tau)
    assert bool(torch.all((got - mirror).abs() <= 1e-6 * torch.clamp(mirror.abs(), min=1.0)))
    assert float(got[3]) == 0.0 and float(got[5]) == 0.0
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = ttk.taumode_plan(n, f, X.data_ptr() % 16 == 0, sms)
    assert plan == ttk.taumode_plan_chosen(X)
    assert plan["loader"] == ("tma" if aligned and f % 4 == 0 else "elementwise")


def test_taumode_kernel_matches_plain_on_the_energy_data(cuda_device):
    from matternet_rs_tpu_torch import ArrowSpaceBuilder
    from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

    Xn = make_energy_test_dataset(4000, 128, 44).astype(np.float32)
    _, gl = (ArrowSpaceBuilder().with_lambda_graph(1.0, 6).with_sparsity_check(False)
             .with_cluster_params(max_clusters=64, radius=25.0).with_sampling(None).build(Xn))
    X, L = torch.from_numpy(Xn).to(cuda_device), gl.matrix.float().contiguous()
    tau = ttm.select_tau(X, ttm.TAU_MEDIAN)
    got = ttk.taumode_lambdas_fused(X, L, tau)
    ref = ttk.taumode_lambdas_plain(X, L, tau)
    mirror = ttk.taumode_lambdas_3xtf32_plain(X, L, tau)
    assert bool(torch.all((got - ref).abs() <= 1e-5 * torch.clamp(ref.abs(), min=1.0)))
    assert bool(torch.all((got - mirror).abs() <= 1e-6 * torch.clamp(mirror.abs(), min=1.0)))


def _fixture(n, f, b, seed, device):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f), dtype=np.float32)
    X[3] = 0.0
    arrs = [X, np.sqrt(np.sum(X * X, axis=1)).astype(np.float32),
            rng.random(n, dtype=np.float32), rng.standard_normal((b, f), dtype=np.float32),
            rng.random(b, dtype=np.float32), rng.uniform(0.3, 0.9, b).astype(np.float32)]
    return [torch.from_numpy(a).to(device) for a in arrs]


def _misaligned(t):
    """A contiguous copy of ``t`` whose address is one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


# mask_from = 5000 falls inside a sub-tile of 256 rows and of 128.
@pytest.mark.parametrize("mask_from", [None, 5000])
@pytest.mark.parametrize("n,f,b,misalign", [
    (6200, 128, 256, False), (4100, 100, 3, False), (4100, 768, 3, False),
    (6200, 100, 300, False), (4100, 768, 300, False), (4100, 99, 5, False),
    (6200, 128, 256, True),
])
def test_tilemax_kernels_match_plain(cuda_device, n, f, b, misalign, mask_from):
    arrs = _fixture(n, f, b, 1, cuda_device)
    if misalign:
        arrs[0] = _misaligned(arrs[0])
    plan = ttmk.scores_tilemax_plan(b, f, aligned=not misalign)
    assert plan["loader"] == ("cp.async" if f % 4 == 0 and not misalign else "elementwise")
    assert ttmk.scores_tilemax_plan_chosen(arrs[0], arrs[3]) == plan
    before = kernels.launch_counts()
    s, m = ttmk.scores_and_tilemax(*arrs, tile=2048, mask_from=mask_from)
    ps, pm = ttmk.scores_and_tilemax_plain(*arrs, tile=2048, mask_from=mask_from)
    sel = torch.sort(tso.topk_stable(pm, 6)[1], dim=1).values
    cand = ttmk.gather_subtiles(s, sel, 256)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["scores_tilemax"] == before["scores_tilemax"] + 1
    assert after["gather_subtiles"] == before["gather_subtiles"] + 1
    fin = torch.isfinite(ps)
    assert torch.equal(fin, torch.isfinite(s))
    assert float((s[fin] - ps[fin]).abs().max()) <= 1e-5
    fm = torch.isfinite(pm)
    assert torch.equal(fm, torch.isfinite(m))
    assert float((m[fm] - pm[fm]).abs().max()) <= 1e-5
    assert torch.equal(cand, ttmk.gather_subtiles_plain(s, sel, 256))


def test_fused_search_on_card_matches_plain_route(cuda_device):
    arrs = _fixture(40_000, 64, 16, 2, cuda_device)
    top, idx = tso.fused_tilemax(*arrs[:5], 10, arrs[5])
    ptop, pidx = tso.fused_tilemax(
        *arrs[:5], 11, arrs[5], producer=ttmk.scores_and_tilemax_plain,
        gather=ttmk.gather_subtiles_plain,
    )
    assert not topk_mismatches(pidx.cpu(), ptop.cpu(), idx.cpu(), top.cpu())


def _stage_inputs(b, ns, nr, kind, device, seed):
    """Kernel B's outputs as the candidate stage takes them: scores
    ``[b, ns·256]``, their sub-tile maxima and a tail ``[b, nr]`` (or None),
    random or integer-valued (ties everywhere); ``misaligned`` puts the
    scores and maxima one element past a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, ns * 256 + nr), dtype=np.float32)
    if kind == "ties":
        s = rng.integers(0, 4, size=s.shape).astype(np.float32)
    s = torch.from_numpy(s).to(device)
    main = s[:, :ns * 256].contiguous()
    tmax = main.view(b, ns, 256).amax(dim=2)
    tail = s[:, ns * 256:].contiguous() if nr else None
    if kind == "misaligned":
        main, tmax = _misaligned(main), _misaligned(tmax)
    return main.view(b, ns, 256), tmax, tail


@pytest.mark.parametrize("kind", ["random", "ties", "misaligned"])
@pytest.mark.parametrize("b,ns,nr", [(1, 64, 0), (7, 5000, 576), (256, 3904, 576), (256, 200, 0),
                                     (7, 8, 2047), (7, 40, 1)])
def test_subtile_topk_kernel_matches_the_chain_bit_for_bit(cuda_device, b, ns, nr, kind):
    main, tmax, tail = _stage_inputs(b, ns, nr, kind, cuda_device, seed=b + ns + nr)
    n = ns * 256 + nr
    for kk in (1, 10, 16):
        before = kernels.launch_counts()
        top, idx = ttmk.select_topk(main, tmax, tail, n, kk, tso.SELECT_MARGIN)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        assert after["subtile_topk"] == before["subtile_topk"] + 1
        assert after["gather_subtiles"] == before["gather_subtiles"]
        ptop, pidx = ttmk.select_topk_plain(main, tmax, tail, n, kk, tso.SELECT_MARGIN)
        assert idx.dtype == torch.int64 and torch.equal(idx, pidx)
        assert _bit_equal(top, ptop)


WIDE_KS = (17, 32, 33, 40, 100, 128)
WIDE_KINDS = ("random", "ties", "zeros", "fills", "nan", "striped", "overstated", "misaligned")


def _wide_inputs(b, ns, nr, kind, device, seed):
    """The wide stage's inputs, made on the card: random normal scores;
    integers 0..2 (ties everywhere); ±0.0 only; half −inf; 1% NaN; large
    scores only at positions p with p mod 2048 < 124 (31 threads' units of
    4: where every sub-tile is selected, more than a list holds reach
    either bar, and the radix select takes over);
    maxima 1 above their sub-tiles' scores (the first bar fails its count);
    or random scores and maxima one element off 16 bytes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = ns * 256 + nr
    u = torch.rand((b, n), device=device, generator=gen)
    v = torch.randn((b, n), device=device, generator=gen)
    if kind == "ties":
        v = torch.floor(u * 3)
    elif kind == "zeros":
        v = torch.where(u < 0.5, -0.0, 0.0)
    elif kind == "fills":
        v = torch.where(u < 0.5, -float("inf"), v)
    elif kind == "nan":
        v = torch.where(u < 0.01, float("nan"), v)
    elif kind == "striped":
        v = v + 10.0 * ((torch.arange(n, device=device) % 2048) < 124)
    main = v[:, :ns * 256].contiguous()
    tmax = main.view(b, ns, 256).amax(dim=2) + (1.0 if kind == "overstated" else 0.0)
    if kind == "misaligned":
        main, tmax = _misaligned(main), _misaligned(tmax)
    return main.view(b, ns, 256), tmax, (v[:, ns * 256:].contiguous() if nr else None), n


@pytest.mark.parametrize("kind", WIDE_KINDS)
@pytest.mark.parametrize("nr", [0, 1, 576, 2047])
@pytest.mark.parametrize("ns", ["c", 3904, 39_056])
def test_subtile_topk_wide_kernel_matches_the_chain_bit_for_bit(cuda_device, ns, nr, kind):
    """For 16 < kk ≤ 128 one launch of the wide stage, values and ids equal
    to the chain's; with every sub-tile selected (ns = kk + 4), phase 2's
    ns and the 10M-row index's; and with a list cap of 0 (every selection
    through the radix select)."""
    assert ttmk.subtile_topk_wide_plan_chosen() == ttmk.subtile_topk_wide_plan()
    b = {"c": 7, 3904: 64, 39_056: 3}[ns]
    shared = None if ns == "c" else _wide_inputs(b, ns, nr, kind, cuda_device, seed=ns + nr)
    for kk in WIDE_KS:
        main, tmax, tail, n = shared or _wide_inputs(b, kk + tso.SELECT_MARGIN, nr, kind, cuda_device,
                                                     seed=kk + nr)
        c = min(main.shape[1], kk + tso.SELECT_MARGIN)
        before = kernels.launch_counts()
        top, idx = ttmk.select_topk(main, tmax, tail, n, kk, tso.SELECT_MARGIN)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        assert after["subtile_topk"] == before["subtile_topk"] + 1
        assert after["gather_subtiles"] == before["gather_subtiles"]
        ptop, pidx = ttmk.select_topk_plain(main, tmax, tail, n, kk, tso.SELECT_MARGIN)
        assert idx.dtype == torch.int64 and torch.equal(idx, pidx)
        assert _bit_equal(top, ptop)
        wide, args, rtop, ridx = ttmk._subtile_topk_operands(main, tmax, tail, n, kk, tso.SELECT_MARGIN)
        assert wide
        ttmk._subtile_topk_launch(wide, args, rtop, ridx, cap=0)
        torch.cuda.synchronize()
        assert torch.equal(ridx, pidx) and _bit_equal(rtop, ptop)


def test_subtile_topk_wide_kernel_refuses_what_it_does_not_take(cuda_device):
    main, tmax, tail, n = _wide_inputs(2, 200, 7, "random", cuda_device, seed=1)
    with pytest.raises(ValueError, match="beyond its limits"):
        ttmk.select_topk(main, tmax, tail, n, 100, 40)          # c = 140 > 132
    wide, args, top, idx = ttmk._subtile_topk_operands(main, tmax, tail, n, 100, tso.SELECT_MARGIN)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ttmk._subtile_topk_launch(wide, args, top, idx, cap=513)


@pytest.mark.parametrize("k,kernel,other", [(10, "subtile_topk", "gather_subtiles"),
                                            (40, "subtile_topk", "gather_subtiles"),
                                            (100, "subtile_topk", "gather_subtiles"),
                                            (200, "gather_subtiles", "subtile_topk")])
def test_fused_search_selects_in_one_launch_up_to_k16_and_gathers_beyond(cuda_device, k, kernel, other):
    arrs = _fixture(40_000, 64, 16, 2, cuda_device)
    before = kernels.launch_counts()
    top, idx = tso.fused_tilemax(*arrs[:5], k, arrs[5])
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after[kernel] == before[kernel] + 1 and after[other] == before[other]
    ptop, pidx = tso.fused_tilemax(*arrs[:5], k, arrs[5], select=ttmk.select_topk_plain)
    assert torch.equal(idx, pidx) and _bit_equal(top, ptop)


# mask_from inside a sub-tile, inside the ragged tail (n0 = 38,912).
@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("mask_from", [None, 30_000, 39_000])
def test_fused_search_makes_no_synchronising_call_after_kernel_b(cuda_device, mask_from, k):
    """From kernel B's launch to its return, ``fused_tilemax`` (k = 10 and
    k = 100, both candidate-stage designs) makes no call that waits for the
    card."""
    arrs = _fixture(40_000, 64, 16, 3, cuda_device)
    ref = tso.fused_tilemax(*arrs[:5], k, arrs[5], mask_from=mask_from)
    torch.cuda.synchronize()

    def producer(*a, **kw):
        out = ttmk.scores_and_tilemax(*a, **kw)
        torch.cuda.set_sync_debug_mode("error")
        return out

    before = kernels.launch_counts()
    try:
        top, idx = tso.fused_tilemax(*arrs[:5], k, arrs[5], mask_from=mask_from, producer=producer)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["scores_tilemax"] == before["scores_tilemax"] + 1
    assert after["subtile_topk"] == before["subtile_topk"] + 1
    assert torch.equal(idx, ref[1]) and torch.equal(top, ref[0])


def _scan_corpus(X, dtype):
    """``(scan corpus, rn)`` for one of kernel D's three modes."""
    if dtype is torch.int8:
        return quantize_rows(X)
    return X.to(dtype), None


# (n, f, b, subs, misaligned corpus): sub-tiles of 128 rows (subs 16) and 256
# (subs 8); F = 100 sends bf16 and int8 rows to the element-wise loader (their
# row pitch is no multiple of 16 bytes), F = 768 narrows the query block, a
# misaligned corpus takes the element-wise loader whatever F is (at 256 and at
# 64 queries a block).
@pytest.mark.parametrize("mask_from", [None, 5000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("n,f,b,subs,misalign", [
    (6200, 128, 256, 16, False), (4100, 100, 3, 16, False), (6200, 128, 256, 8, False),
    (6200, 100, 300, 16, False), (4100, 768, 3, 8, False), (4100, 768, 300, 16, False),
    (6200, 128, 40, 16, False), (6200, 128, 256, 16, True), (4100, 99, 40, 8, True),
])
def test_tilemax_only_kernel_matches_plain(cuda_device, n, f, b, subs, misalign, dtype, mask_from):
    arrs = _fixture(n, f, b, 3, cuda_device)
    Xs, rn = _scan_corpus(arrs[0], dtype)
    if misalign:
        Xs = _misaligned(Xs)
    plan = trsk.tilemax_only_plan(b, f, dtype, aligned=Xs.data_ptr() % 16 == 0)
    pitch_ok = (f * Xs.element_size()) % 16 == 0
    assert plan["loader"] == ("cp.async" if pitch_ok and not misalign else "elementwise")
    assert trsk.tilemax_only_plan_chosen(Xs, b) == plan
    before = kernels.launch_counts()["tilemax_only"]
    m = trsk.tilemax_only(Xs, *arrs[1:], tile=2048, subs=subs, mask_from=mask_from, rn=rn)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["tilemax_only"] == before + 1
    pm = trsk.tilemax_only_plain(Xs, *arrs[1:], tile=2048, subs=subs, mask_from=mask_from, rn=rn)
    assert m.shape == pm.shape == (b, (n // 2048) * subs)
    fin = torch.isfinite(pm)
    assert torch.equal(fin, torch.isfinite(m))
    assert float((m[fin] - pm[fin]).abs().max()) <= 1e-5


def test_tilemax_only_kernel_refuses_rows_too_wide_for_16_queries(cuda_device):
    arrs = _fixture(2100, 2600, 4, 3, cuda_device)
    with pytest.raises(ValueError, match="no room for 16 queries"):
        trsk.tilemax_only(*arrs, tile=2048, subs=16)
    with pytest.raises(RuntimeError, match="invalid argument"):
        trsk.tilemax_only_plan_chosen(arrs[0], 4)
    wide = _fixture(2100, 2560, 4, 3, cuda_device)      # the widest f32 rows it takes
    m = trsk.tilemax_only(*wide, tile=2048, subs=16)
    pm = trsk.tilemax_only_plain(*wide, tile=2048, subs=16)
    assert float((m - pm).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("f,b", [(128, 256), (100, 5)])
def test_slab_dots_kernel_matches_plain(cuda_device, f, b, dtype):
    X, _, _, Q, _, _ = _fixture(9000, f, b, 4, cuda_device)
    Xr = quantize_rows(X)[0] if dtype is torch.int8 else X
    ts, c = 128, 14
    sel = torch.sort(torch.randint(0, 9000 // ts, (b, c), device=cuda_device), dim=1).values
    before = kernels.launch_counts()["slab_dots"]
    d = trsk.slab_dots(Xr, Q, sel, ts)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["slab_dots"] == before + 1
    pd = trsk.slab_dots_plain(Xr, Q, sel, ts)
    rows = sel[:, :, None] * ts + torch.arange(ts, device=cuda_device)
    scale = torch.linalg.norm(Q, dim=1)[:, None, None] * torch.linalg.norm(Xr.float(), dim=1)[rows]
    assert bool(torch.all((d - pd).abs() <= 1e-5 * scale))
    with pytest.raises(ValueError, match="slab ids"):
        trsk.slab_dots(Xr, Q, torch.full_like(sel, 9000 // ts), ts)


def test_rescored_route_on_card_matches_plain_route(cuda_device):
    """The bf16x3_rescored tier's route (kernels D and E) against the same
    route through their plain versions."""
    arrs = _fixture(40_000, 128, 16, 2, cuda_device)
    assert tso.fused_rescored_path(40_000, 128, 16, 10, 64)
    idx, top = tso.fused_scan_rescored(arrs[0], *arrs[:5], 10, 64, arrs[5])
    pidx, ptop = tso.fused_scan_rescored(
        arrs[0], *arrs[:5], 10, 64, arrs[5],
        producer=trsk.tilemax_only_plain, slab_reader=trsk.slab_dots_plain,
    )
    assert not same_k_mismatches(pidx.cpu(), ptop.cpu(), idx.cpu(), top.cpu())


def _ell_arrays(n, k, seed, device):
    """A random ELL graph whose empty slots carry index −1 (as the direct
    build writes them) or an arbitrary in-range id."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n, k)).astype(np.int32)
    w = rng.random((n, k)).astype(np.float32)
    empty = rng.random((n, k)) < 0.3
    w[empty] = 0.0
    idx[empty & (rng.random((n, k)) < 0.5)] = -1
    return torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


@pytest.mark.parametrize("with_diag", [False, True])
@pytest.mark.parametrize("n,k,m", [(16384, 12, 15), (16384, 12, 1), (1000, 40, 256),
                                   (137, 3, 300), (5, 1, 2)])
def test_spmv_ell_kernel_matches_plain(cuda_device, n, k, m, with_diag):
    idx, w = _ell_arrays(n, k, 11, cuda_device)
    X = torch.from_numpy(
        np.random.default_rng(12).normal(size=(n, m)).astype(np.float32)).to(cuda_device)
    d = torch.sum(w, dim=1) if with_diag else None
    before = kernels.launch_counts()["spmv_ell"]
    got = tfk.spmv_ell(idx, w, X, d)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["spmv_ell"] == before + 1
    ref = tfk.spmv_ell_plain(idx, w, X, d)
    live = torch.where(w != 0, idx, 0).long()
    scale = (w.abs()[:, :, None] * X[live].abs()).sum(dim=1)
    if d is not None:
        scale = scale + d[:, None] * X.abs()
    assert bool(torch.all((got - ref).abs() <= 1e-5 * scale))


def test_spmv_ell_kernel_skips_empty_slots_and_rejects_bad_live_ones(cuda_device):
    n = 300
    idx, w = _ell_arrays(n, 6, 13, cuda_device)
    live = w != 0
    idx = torch.where(live, idx.clamp(max=n - 2), idx)      # no live slot names row n-1
    X = torch.randn(n, 7, device=cuda_device)
    ref = tfk.spmv_ell(idx, w, X)
    # Empty slots at −1, or naming a non-finite row, contribute nothing.
    X_inf = X.clone()
    X_inf[n - 1] = float("inf")
    for fill in (-1, n - 1, 10**6):
        got = tfk.spmv_ell(torch.where(live, idx, fill).to(torch.int32), w, X_inf)
        assert torch.equal(got, ref)
    bad = idx.clone()
    r, c = live.nonzero()[0].tolist()
    for value in (n, -1):
        bad[r, c] = value
        with pytest.raises(ValueError, match="outside"):
            tfk.spmv_ell(bad, w, X)
    with pytest.raises(ValueError, match="int32"):
        tfk.spmv_ell(idx.long(), w, X)


def test_csr_products_and_lobpcg_go_through_kernel_f(cuda_device):
    nodes = torch.from_numpy(
        np.random.default_rng(14).normal(size=(400, 30)).astype(np.float32)).to(cuda_device)
    params = GraphParams(eps=1.0, k=6, topk=4, sparsity_check=False)
    gl = tlap.build_laplacian_ell(nodes, params, row_tile=128)
    dense = tlap.build_laplacian_matrix(nodes, params)
    assert float((gl.dense() - dense.matrix).abs().max()) <= 1e-6
    ell = gl.ell()
    ones = torch.ones(400, device=cuda_device)
    assert float(gl.multiply_vector(ones).abs().max()) <= 1e-5
    V = torch.randn(400, 9, device=cuda_device)
    assert float((tcsr.laplacian_spmv_ell(ell.indices, ell.weights, V)
                  - dense.matrix @ V).abs().max()) <= 1e-4
    before = kernels.launch_counts()["spmv_ell"]
    vals, vecs = teig.lobpcg_smallest(ell, 4, iters=50)
    assert kernels.launch_counts()["spmv_ell"] == before + 51
    true = np.linalg.eigvalsh(dense.matrix.double().cpu().numpy())[:4]
    assert np.allclose(vals, true, atol=1e-3)


def _search_fused_fixture(n, f, b, seed, device, ties=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    if ties:
        X[100:140] = X[7]                 # exact score ties, broken by id
    Xn = X / np.linalg.norm(X, axis=1, keepdims=True)
    lam = rng.random(n).astype(np.float32)
    if ties:
        lam[100:140] = lam[7]
        lam[55] = 2.0                     # a masked (padded-row) λ
    arrs = [Xn, lam, Xn[:b].copy(), rng.random(b).astype(np.float32)]
    return [torch.from_numpy(a).to(device) for a in arrs]



# Where a query sits in a batch: alone, at rows 63, 64 and 65 (the last row
# of a query block, the first of the next, the one after), and inside
# batches of 256 and 1024. Each accumulator is one fmaf chain in ascending
# k, so none of these may change a bit of its scores, maxima or lists.
_BATCH_PLACES = [(1, 0), (66, 63), (66, 64), (66, 65), (256, 200), (1024, 1000)]


def _placed(pool, probe, b, at):
    """Rows ``pool[:b]`` with row ``at`` replaced by ``probe`` (on the card)."""
    batch = pool[:b].clone()
    batch[at] = probe
    return batch.contiguous()


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("misalign", [False, True])
@pytest.mark.parametrize("f", [1, 3, 96, 128, 130])
def test_tilemax_kernel_bits_do_not_depend_on_the_batch_tiling(cuda_device, f, misalign):
    """Kernel B: the scores and sub-tile maxima of one query are the same
    bits wherever the query sits in the batch and whatever the batch size,
    with 16-byte copies and with the element-wise loader."""
    X, norms, lams, Q, ql, alphas = _fixture(4700, f, 1024, 11, cuda_device)
    if misalign:
        X = _misaligned(X)
    assert ttmk.scores_tilemax_plan_chosen(X, Q)["loader"] == (
        "cp.async" if f % 4 == 0 and not misalign else "elementwise")
    ref = None
    for b, at in _BATCH_PLACES:
        rows = lambda t: _placed(t, t[5], b, at)    # query 5 of the pool, moved to row `at`
        s, m = ttmk.scores_and_tilemax(X, norms, lams, rows(Q), rows(ql), rows(alphas), tile=2048)
        got = (_bits(s[at]), _bits(m[at]))
        if ref is None:
            ref = got
            ps, pm = ttmk.scores_and_tilemax_plain(X, norms, lams, Q[5:6], ql[5:6], alphas[5:6], tile=2048)
            assert float((s[at] - ps[0]).abs().max()) <= 1e-5
            assert float((m[at] - pm[0]).abs().max()) <= 1e-5
        else:
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (b, at)


@pytest.mark.parametrize("f,misalign", [(128, False), (130, False), (96, True)])
def test_search_fused_bits_do_not_depend_on_splits_or_batch_tiling(cuda_device, f, misalign):
    """Kernel G: the merged values and ids of one query are the same bits
    for 1 range, 7 ranges and the default number, wherever the query sits
    in the batch and whatever the batch size."""
    Xn, lam, Qn, qlam = _search_fused_fixture(40_000, f, 1024, 21, cuda_device, ties=True)
    if misalign:
        Xn = _misaligned(Xn)
    ref = None
    for b, at in _BATCH_PLACES:
        rows = lambda t: _placed(t, t[7], b, at)
        for splits in (1, 7, None):
            idx, val = tsf.search_fused(Xn, lam, rows(Qn), rows(qlam), 10, splits=splits)
            got = (idx[at].clone(), _bits(val[at]))
            if ref is None:
                ref = got
            else:
                assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (b, at, splits)


@pytest.mark.parametrize("n,f,b,k,ties", [(3000, 64, 8, 10, False), (2777, 100, 70, 16, True),
                                          (40_000, 128, 256, 10, False), (12, 8, 3, 16, False)])
def test_search_fused_kernel_matches_plain_for_any_split_count(cuda_device, n, f, b, k, ties):
    arrs = _search_fused_fixture(n, f, b, 15, cuda_device, ties)
    pidx, pval = tsf.search_fused_plain(arrs[0], arrs[1], arrs[2], arrs[3], k)
    kk = pidx.shape[1]
    ref_idx, ref_val = None, None
    for splits in (1, 7):
        before = kernels.launch_counts()
        idx, val = tsf.search_fused(*arrs, k, splits=splits)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        assert after["search_fused"] == before["search_fused"] + 1
        assert after["search_fused_merge"] == before["search_fused_merge"] + 1
        assert idx.dtype == torch.int32 and idx.shape == (b, kk)
        assert float((val - pval).abs().max()) <= 1e-5
        assert bool(torch.all(val[:, 1:] <= val[:, :-1]))
        if ref_idx is None:
            ref_idx, ref_val = idx, val
        else:                             # a total order: the split count changes nothing
            assert torch.equal(idx, ref_idx) and torch.equal(val, ref_val)
    if kk < n:
        p1 = tsf.search_fused_plain(arrs[0], arrs[1], arrs[2], arrs[3], min(kk + 1, 16))
        if p1[0].shape[1] == kk + 1:
            assert not topk_mismatches(p1[0].cpu(), p1[1].cpu(), ref_idx.cpu(), ref_val.cpu())
    else:
        assert torch.equal(torch.sort(ref_idx, dim=1).values,
                           torch.arange(n, dtype=torch.int32, device=cuda_device).expand(b, n))
    if ties:                              # equal scores come lowest id first
        same = (ref_val[:, 1:] == ref_val[:, :-1])
        assert bool(torch.all(ref_idx[:, 1:][same] > ref_idx[:, :-1][same]))
        assert not bool((ref_idx == 55).any())
    with pytest.raises(ValueError, match="K_PAD"):
        tsf.search_fused(*arrs, 17)


def test_search_fused_partials_and_merge_match_plain(cuda_device):
    arrs = _search_fused_fixture(9000, 64, 20, 16, cuda_device)
    vals, ids = tsf.scan_partials(*arrs, 10, 0.7, 5)
    pvals, pids = tsf.scan_partials_plain(*arrs, 10, 0.7, 5)
    assert float((vals[:, :, :10] - pvals[:, :, :10]).abs().max()) <= 1e-5
    for k in (1, 10, 16):
        i_k, v_k = tsf.merge_partials(vals, ids, k)
        i_p, v_p = tsf.merge_partials_plain(vals, ids, k)
        assert torch.equal(i_k, i_p) and torch.equal(v_k, v_p)


def _merge_lists(b, cand, kind, seed, device):
    """``[b, cand / 16, 16]`` candidate lists, unsorted: random scores;
    all scores equal (ties fall to the ids, some ids repeated); ±0.0 only;
    half the entries −inf with ``EMPTY_ID``."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(b, cand)).astype(np.float32)
    i = rng.integers(0, 50 * cand, size=(b, cand)).astype(np.int32)
    if kind == "ties":
        v[:] = 0.25
        i = rng.integers(0, cand, size=(b, cand)).astype(np.int32)
    elif kind == "zeros":
        v = np.where(rng.random((b, cand)) < 0.5, np.float32(-0.0), np.float32(0.0))
        i = rng.integers(0, cand // 2 + 1, size=(b, cand)).astype(np.int32)
    elif kind == "fills":
        empty = rng.random((b, cand)) < 0.5
        v[empty] = -np.inf
        i[empty] = tsf.EMPTY_ID
    return (torch.from_numpy(v.reshape(b, -1, 16)).to(device),
            torch.from_numpy(i.reshape(b, -1, 16)).to(device))


@pytest.mark.parametrize("kind", ["random", "ties", "zeros", "fills"])
@pytest.mark.parametrize("b,cand", [(1, 16), (7, 48), (256, 2112), (7, 4112)])
def test_search_fused_merge_matches_plain_bit_for_bit(cuda_device, b, cand, kind):
    vals, ids = _merge_lists(b, cand, kind, cand + b, cuda_device)
    for k in (1, 10, 16):
        before = kernels.launch_counts()["search_fused_merge"]
        i_k, v_k = tsf.merge_partials(vals, ids, k)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["search_fused_merge"] == before + 1
        i_p, v_p = tsf.merge_partials_plain(vals, ids, k)
        assert torch.equal(i_k, i_p)
        assert torch.equal(v_k.view(torch.int32), v_p.view(torch.int32))


def _bit_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("k", [1, 14, 40])
@pytest.mark.parametrize("n", [1, 31, 16384])
def test_spmv_ell_kernel_is_bit_equal_at_edge_shapes(cuda_device, n, k):
    """Every m of the plan's table, both forms, bit for bit: every tenth row
    has no live slot, empty slots carry −1 or name a row of inf that no
    live slot names; the plan is the library's own."""
    rng = np.random.default_rng(n + k)
    poison = n - 1 if n > 1 else None
    idx = rng.integers(0, max(n - 1, 1), size=(n, k)).astype(np.int32)
    w = rng.random((n, k)).astype(np.float32)
    empty = rng.random((n, k)) < 0.3
    empty[::10] = True
    w[empty] = 0.0
    idx[empty] = -1
    if poison is not None:
        idx[empty & (rng.random((n, k)) < 0.5)] = poison
    idx, w = torch.from_numpy(idx).to(cuda_device), torch.from_numpy(w).to(cuda_device)
    for m in (1, 2, 15, 16, 17, 33, 256, 300):
        X = torch.from_numpy(rng.normal(size=(n, m)).astype(np.float32)).to(cuda_device)
        if poison is not None:
            X[poison] = float("inf")
        for d in (None, w.sum(dim=1)):
            got = tfk.spmv_ell(idx, w, X, d, checked=True)
            assert _bit_equal(got, tfk.spmv_ell_plain(idx, w, X, d)), (m, d is None)
            rows = torch.arange(n, device=cuda_device) != (n - 1 if poison is not None else -1)
            assert bool(torch.isfinite(got[rows]).all())
        assert tfk.spmv_ell_plan_chosen(n, k, m) == tfk.spmv_ell_plan(n, k, m)


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8], ids=str)
@pytest.mark.parametrize("f", [1, 3, 100, 128, 768, 2048])
def test_slab_dots_kernel_matches_plain_at_edge_shapes(cuda_device, f, dtype, offset):
    """Kernel E through the public wrapper against the plain version; the
    plan is the library's."""
    rng = np.random.default_rng(f)
    nslabs = 20
    for ts in (128, 256):
        X = torch.from_numpy(rng.standard_normal((nslabs * ts + 5, f), dtype=np.float32)).to(cuda_device)
        Xr = quantize_rows(X)[0] if dtype is torch.int8 else X
        if offset:                          # 4 bytes past the allocation's start
            per = 4 // Xr.element_size()
            buf = torch.empty(Xr.numel() + per, dtype=Xr.dtype, device=cuda_device)
            view = buf[per:].view(Xr.shape)
            view.copy_(Xr)
            Xr = view
        for c in (1, 14):
            for b in (1, 7, 256):
                Q = torch.from_numpy(rng.standard_normal((b, f), dtype=np.float32)).to(cuda_device)
                sel = torch.sort(torch.from_numpy(rng.integers(0, nslabs, (b, c))).to(cuda_device),
                                 dim=1).values
                d = trsk.slab_dots(Xr, Q, sel, ts, checked=True)
                per_q = max(1, (1 << 28) // (c * ts * f * 4))
                pd = torch.cat([trsk.slab_dots_plain(Xr, Q[i:i + per_q], sel[i:i + per_q], ts)
                                for i in range(0, b, per_q)])
                rows = sel[:, :, None] * ts + torch.arange(ts, device=cuda_device)
                scale = torch.linalg.norm(Q, dim=1)[:, None, None] * torch.linalg.norm(Xr.float(), dim=1)[rows]
                assert bool(torch.all((d - pd).abs() <= 1e-5 * scale)), (ts, c, b)
                assert trsk.slab_dots_plan_chosen(Xr, b, c, ts) == trsk.slab_dots_plan(
                    b, c, f, dtype, x_addr=Xr.data_ptr(), ts=ts,
                    sms=torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    bad = torch.tensor([[0, 3], [4, nslabs], [-1, 2]], device=cuda_device)
    d = trsk.slab_dots(Xr, torch.ones((3, f), device=cuda_device), bad, 256, checked=True)
    assert bool(torch.isnan(d[1, 1]).all() and torch.isnan(d[2, 0]).all())
    assert bool(torch.isfinite(d[0]).all() and torch.isfinite(d[1, 0]).all() and torch.isfinite(d[2, 1]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8], ids=str)
def test_rescored_route_makes_no_synchronising_call_after_kernel_d(cuda_device, dtype):
    """From kernel D's launch to its return, ``fused_scan_rescored`` makes
    no call that waits for the card: kernel E takes the slab ids on trust."""
    arrs = _fixture(40_000, 128, 16, 5, cuda_device)
    Xs, rn = _scan_corpus(arrs[0], torch.int8 if dtype is torch.int8 else torch.float32)
    args = (Xs, arrs[0], *arrs[1:5], 10, 64, arrs[5])
    before = kernels.launch_counts()
    ref = tso.fused_scan_rescored(*args, scan_rn=rn)
    torch.cuda.synchronize()

    def producer(*a, **kw):
        out = trsk.tilemax_only(*a, **kw)
        torch.cuda.set_sync_debug_mode("error")
        return out

    try:
        idx, top = tso.fused_scan_rescored(*args, scan_rn=rn, producer=producer)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["tilemax_only"] == before["tilemax_only"] + 2
    assert after["slab_dots"] == before["slab_dots"] + 2
    assert torch.equal(idx, ref[0]) and torch.equal(top, ref[1])
    # The check this path skips is one such call: the mode catches it.
    sel = torch.zeros((16, 2), dtype=torch.int64, device=cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            trsk.slab_dots(arrs[0], arrs[3], sel, 128)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("offset", [0, 16, 4], ids=["aligned", "offset16", "offset4"])
@pytest.mark.parametrize("f", [1, 96, 130])
@pytest.mark.parametrize("c", [1, 14, 64])
@pytest.mark.parametrize("b", [1, 7, 256])
def test_slab_dots_int8_rows_match_plain(cuda_device, b, c, f, offset):
    """Kernel E on int8 rows (the ring where the plan takes it: F = 96 with
    X on 16 bytes; the pair design at F = 1 and 130 and 4 bytes off), each
    query's last slab the corpus's last whole one, against the plain
    version; the plan is the library's."""
    rng = np.random.default_rng(b * 1000 + c * 10 + f)
    ts, nslabs = 128, 70
    X8 = quantize_rows(torch.from_numpy(
        rng.standard_normal((nslabs * ts + 5, f), dtype=np.float32)).to(cuda_device))[0]
    buf = torch.empty(X8.numel() + offset, dtype=torch.int8, device=cuda_device)
    Xr = buf[offset:].view(X8.shape)
    Xr.copy_(X8)
    Q = torch.from_numpy(rng.standard_normal((b, f), dtype=np.float32)).to(cuda_device)
    sel = torch.sort(torch.from_numpy(rng.integers(0, nslabs, (b, c))).to(cuda_device), dim=1).values
    sel[:, -1] = nslabs - 1
    d = trsk.slab_dots(Xr, Q, sel, ts, checked=True)
    pd = trsk.slab_dots_plain(Xr, Q, sel, ts)
    rows = sel[:, :, None] * ts + torch.arange(ts, device=cuda_device)
    scale = torch.linalg.norm(Q, dim=1)[:, None, None] * torch.linalg.norm(Xr.float(), dim=1)[rows]
    assert bool(torch.all((d - pd).abs() <= 1e-5 * scale))
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = trsk.slab_dots_plan(b, c, f, torch.int8, x_addr=Xr.data_ptr(), ts=ts, sms=sms)
    assert trsk.slab_dots_plan_chosen(Xr, b, c, ts) == plan
    assert plan["design"] == ("ring" if f == 96 and offset != 4 else "pair")


def test_slab_dots_designs_agree_on_int8_rows(cuda_device):
    """The ring and the pair design, forced, give the same dots up to the
    order of summation."""
    rng = np.random.default_rng(3)
    X8 = quantize_rows(torch.from_numpy(rng.standard_normal((300 * 128, 96), dtype=np.float32))
                       .to(cuda_device))[0]
    Q = torch.from_numpy(rng.standard_normal((256, 96), dtype=np.float32)).to(cuda_device)
    sel = torch.sort(torch.from_numpy(rng.integers(0, 300, (256, 14))).to(cuda_device), dim=1).values
    outs = {}
    for design in ("ring", "pair"):
        outs[design] = torch.empty((256, 14, 128), device=cuda_device)
        trsk._slab_dots_launch(X8, Q, sel, 128, outs[design], design=design)
    rows = sel[:, :, None] * 128 + torch.arange(128, device=cuda_device)
    scale = torch.linalg.norm(Q, dim=1)[:, None, None] * torch.linalg.norm(X8.float(), dim=1)[rows]
    assert bool(torch.all((outs["ring"] - outs["pair"]).abs() <= 1e-5 * scale))


def test_sketch_search_launches_d_and_e_once_a_batch_without_a_read_back(cuda_device, tmp_path):
    """``search_batch_sketch`` on a suffix-padded sketch takes the
    maxima-first scan: one launch of kernel D and one of kernel E a batch,
    and nothing is read back from the query λ to the candidate ids."""
    from matternet_rs_tpu_torch.index.streaming import StreamingIndex
    from matternet_rs_tpu_torch.storage import shards

    rng = np.random.default_rng(19)
    centres = rng.normal(size=(16, 48)) * 4.0
    data = (centres[rng.integers(0, 16, 70_000)] + rng.normal(size=(70_000, 48))).astype(np.float32)
    shards.write_shards(data, tmp_path, rows_per_shard=30_000)
    idx = StreamingIndex.build_from_store(tmp_path, GraphParams(eps=1.0, k=6, topk=6, sparsity_check=False),
                                          32, 25.0, block_rows=32_768, sample_rows=20_000)
    idx.build_sketch(persist=False)
    assert idx._sketch_suffix_pad
    idx.sketch_maxfirst = True
    Q = torch.from_numpy(data[rng.choice(70_000, 64, replace=False)]).to(cuda_device)
    kernels.reset_launches()
    for refine in (True, False):
        ids, _ = idx.search_batch_sketch(Q, 10, refine=refine)
        assert ids.shape == (64, 10)
    counts = kernels.launch_counts()
    assert counts["tilemax_only"] == 2 and counts["slab_dots"] == 2
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ql = idx._query_lambdas(Q)
        _, cand = idx._sketch_candidates(Q, ql, 10, 40)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cand.shape == (64, 40)
