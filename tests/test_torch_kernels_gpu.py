"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card (marker ``gpu``) and skips without
one. This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: λ |Δ| ≤ 1e-5·max(1, |λ|); scores and maxima ≤ 1e-5 abs (the
kernels sum the dot products in another order than cuBLAS); the gather
bit for bit.
"""

import numpy as np
import pytest
import torch

from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops import laplacian as tlap
from matternet_rs_tpu_torch.ops import search as tso
from matternet_rs_tpu_torch.ops import taumode as ttm
from matternet_rs_tpu_torch.ops.kernels import taumode as ttk
from matternet_rs_tpu_torch.ops.kernels import tilemax as ttmk
from matternet_rs_tpu_torch.utils.parity import topk_mismatches

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
