"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card (marker ``gpu``) and skips without
one. This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: λ |Δ| ≤ 1e-5·max(1, |λ|); scores and maxima ≤ 1e-5 abs (the
kernels sum the dot products in another order than cuBLAS); the gather
bit for bit; slab dots ≤ 1e-5·‖q‖·‖x‖; routed results under the same-k
rule of ``utils/parity.same_k_mismatches``.
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
from matternet_rs_tpu_torch.ops.kernels import rescored as trsk
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
    nodes = np.random.default_rng(seed).normal(size=(f, 30)).astype(np.float32)
    gl = tlap.build_laplacian_matrix(
        torch.from_numpy(nodes).to(device),
        GraphParams(eps=0.9, k=5, topk=5, sparsity_check=False),
    )
    return gl.matrix.contiguous()


@pytest.mark.parametrize("n,f", [(1000, 24), (777, 128), (300, 768), (65, 2048)])
def test_taumode_kernel_matches_plain(cuda_device, n, f):
    L = _laplacian(f, 6, cuda_device)
    X = np.random.default_rng(7).normal(size=(n, f)).astype(np.float32)
    X[3] = 0.0
    X[5] = 1e-11
    X = torch.from_numpy(X).to(cuda_device)
    tau = ttm.select_tau(X, ttm.TAU_MEDIAN)
    before = kernels.launch_counts()["taumode"]
    got = ttk.taumode_lambdas_fused(X, L, tau)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["taumode"] == before + 1
    ref = ttk.taumode_lambdas_plain(X, L, tau)
    assert bool(torch.all((got - ref).abs() <= 1e-5 * torch.clamp(ref.abs(), min=1.0)))
    assert float(got[3]) == 0.0 and float(got[5]) == 0.0


def _fixture(n, f, b, seed, device):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f), dtype=np.float32)
    X[3] = 0.0
    arrs = [X, np.sqrt(np.sum(X * X, axis=1)).astype(np.float32),
            rng.random(n, dtype=np.float32), rng.standard_normal((b, f), dtype=np.float32),
            rng.random(b, dtype=np.float32), rng.uniform(0.3, 0.9, b).astype(np.float32)]
    return [torch.from_numpy(a).to(device) for a in arrs]


@pytest.mark.parametrize("mask_from", [None, 5000])
@pytest.mark.parametrize("n,f,b", [(6200, 128, 256), (4100, 100, 3)])
def test_tilemax_kernels_match_plain(cuda_device, n, f, b, mask_from):
    arrs = _fixture(n, f, b, 1, cuda_device)
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


def _scan_corpus(X, dtype):
    """``(scan corpus, rn)`` for one of kernel D's three modes."""
    if dtype is torch.int8:
        return quantize_rows(X)
    return X.to(dtype), None


@pytest.mark.parametrize("mask_from", [None, 5000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("n,f,b", [(6200, 128, 256), (4100, 100, 3)])
def test_tilemax_only_kernel_matches_plain(cuda_device, n, f, b, dtype, mask_from):
    arrs = _fixture(n, f, b, 3, cuda_device)
    Xs, rn = _scan_corpus(arrs[0], dtype)
    before = kernels.launch_counts()["tilemax_only"]
    m = trsk.tilemax_only(Xs, *arrs[1:], tile=2048, subs=16, mask_from=mask_from, rn=rn)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["tilemax_only"] == before + 1
    pm = trsk.tilemax_only_plain(Xs, *arrs[1:], tile=2048, subs=16, mask_from=mask_from, rn=rn)
    assert m.shape == pm.shape == (b, (n // 2048) * 16)
    fin = torch.isfinite(pm)
    assert torch.equal(fin, torch.isfinite(m))
    assert float((m[fin] - pm[fin]).abs().max()) <= 1e-5


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
