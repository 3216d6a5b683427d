"""Item mutation, append and the staged pipeline's tiled pass on the card:
``add_items`` of 32,768 rows (kernel A's route) and ``recompute_lambdas``
held against the kernel's plain version, a mutated row served by every
tier through the kernels, the IVF search at full probe against the exact
tier, and the tiled Bhattacharyya pass against its plain (untiled,
float64) form. Every test needs a CUDA card and ``nvcc`` (marker ``gpu``)
and skips without them. This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_pipeline_gpu.py

Tolerances: kernel A's λ within 1e-5·max(|λ|, 1) of its plain version
(its contract), normalised by the index's range; a mutated row's returned
score within 1e-5 of its exact blend; IVF at full probe against the exact
tier under the near-tie rule at 1e-5; the tiled pass within 1e-5 of
float64 relative to its summands' magnitude (the log terms cancel for near
pairs) and bit-equal across block sizes.
"""

import copy

import numpy as np
import pytest
import torch

from matternet_rs_tpu_torch import backend
from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder
from matternet_rs_tpu_torch.ops import distance as dist
from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops import taumode as tmo
from matternet_rs_tpu_torch.ops.kernels import taumode as tk
from matternet_rs_tpu_torch.ops.kernels.tilemax import blend
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset
from matternet_rs_tpu_torch.utils.parity import topk_mismatches

pytestmark = pytest.mark.gpu

N, F, K = 65_536, 64, 10
TIERS = (False, "int8_rescored", "bf16x3_rescored")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if backend.nvcc_path() is None:
        pytest.skip("needs nvcc to build the kernels")


@pytest.fixture(scope="module")
def index():
    _card()
    data = make_energy_test_dataset(N, F, seed=17).astype(np.float32)
    aspace, gl = (ArrowSpaceBuilder().with_lambda_graph(1.0, 6).with_sparsity_check(False)
                  .with_cluster_params(max_clusters=64, radius=25.0).with_sampling(None)
                  .build(data))
    return data, aspace, gl


def _lam_gap(got, X, L, sp):
    """Largest gap of stored normalised λ to kernel A's plain version,
    in raw units over max(|λ|, 1)."""
    tau = tmo.select_tau(X, tmo.TAU_MEDIAN)
    ref = tk.taumode_lambdas_plain(X, L, tau)
    raw = got * sp.range_lambdas + sp.min_lambdas
    return float(((raw - ref).abs() / torch.clamp(ref.abs(), min=1.0)).max())


def test_add_items_launches_kernel_a_once(index):
    data, aspace, gl = index
    sp = copy.deepcopy(aspace)
    new = (data[:32_768] + np.random.default_rng(1).normal(0, 0.3, (32_768, F))).astype(np.float32)
    kernels.reset_launches()
    sp.add_items(new, gl)
    assert kernels.launch_counts()["taumode"] == 1
    lam_new = sp.lambdas[N:]
    assert float(lam_new.min()) >= 0.0 and float(lam_new.max()) <= 1.0
    X = torch.from_numpy(new).cuda()
    raw_ref = tk.taumode_lambdas_plain(X, gl.matrix, tmo.select_tau(X, tmo.TAU_MEDIAN))
    ref = torch.clamp((raw_ref - sp.min_lambdas) / sp.range_lambdas, 0.0, 1.0)
    assert float(((lam_new - ref).abs() * sp.range_lambdas).max()) <= 1e-5 * max(
        1.0, float(raw_ref.abs().max()))
    idx, _ = sp.search_batch(new[:256], gl, 1)
    assert np.array_equal(idx[:, 0], np.arange(N, N + 256))


def test_recompute_lambdas_is_kernel_a_over_all_rows(index):
    data, aspace, gl = index
    sp = copy.deepcopy(aspace)
    kernels.reset_launches()
    sp.scale_item(3, 2.5, gl)
    assert kernels.launch_counts()["taumode"] == 1
    assert _lam_gap(sp.lambdas, sp.data, gl.matrix, sp) <= 1e-5


def test_set_item_is_served_by_every_tier_through_the_kernels(index):
    data, aspace, gl = index
    sp = copy.deepcopy(aspace)
    r, s = 777, 4242
    for tier in TIERS:
        sp.search_batch(data[:256], gl, K, quantized=tier)
    sp.set_item(r, data[s] * 1.5)
    sp.recompute_lambdas(gl)
    Q = np.concatenate([sp.data[r:r + 1].cpu().numpy(), data[:255]])
    raw = sp.search_batch(Q, gl, K, return_raw=True)[2]
    ql = torch.clamp((torch.from_numpy(raw[:1]).cuda() - sp.min_lambdas) / sp.range_lambdas, 0, 1)
    q = sp.data[r]
    own = float(blend(torch.dot(q, q)[None], sp.norms[r] * torch.sqrt(torch.dot(q, q)),
                      sp.lambdas[r], ql, 0.7)[0])
    for tier in TIERS:
        kernels.reset_launches()
        idx, sc = sp.search_batch(Q, gl, K, quantized=tier)
        counts = kernels.launch_counts()
        assert (counts["scores_tilemax"] if tier is False else counts["tilemax_only"]) == 1, tier
        assert r in idx[0], tier
        assert abs(float(sc[0, list(idx[0]).index(r)]) - own) <= 1e-5, tier


def test_ivf_full_probe_equals_the_exact_tier(index):
    data, aspace, gl = index
    sp = copy.deepcopy(aspace)
    sp.build_ivf_index()
    Q = data[np.random.default_rng(4).choice(N, 64, replace=False)]
    ref_i, ref_s = sp.search_batch(Q, gl, K + 1)
    got_i, got_s = sp.search_batch_ivf(Q, gl, K, nprobe=sp.ivf.n_buckets)
    assert not topk_mismatches(ref_i, ref_s, got_i, got_s)


@pytest.mark.parametrize("shape", [(2000, 100), (100, 3000)], ids=["stage-b1", "stage-c"])
def test_tiled_bhattacharyya_against_the_untiled_float64_form(shape):
    _card()
    m, f = shape
    g = torch.Generator(device="cuda").manual_seed(5)
    mu = torch.randn(m, f, device="cuda", generator=g)
    var = torch.rand(m, f, device="cuda", generator=g) + 0.01
    got = dist.bhattacharyya_pairwise(mu, var)
    small = dist.bhattacharyya_pairwise(mu, var, block_elems=m * f)     # one row a block
    assert torch.equal(got, small)
    rows = slice(0, 256)
    va, vb = var[rows, None].double(), var[None].double()
    vbar = 0.5 * (va + vb)
    diff = mu[rows, None].double() - mu[None].double()
    m_terms = diff * diff / vbar
    ref = 0.125 * m_terms.sum(-1) + 0.5 * (
        torch.log(vbar) - 0.5 * (torch.log(va) + torch.log(vb))).sum(-1)
    scale = 0.125 * m_terms.sum(-1) + 0.5 * (torch.log(vbar).abs() + 0.5 * (
        torch.log(va).abs() + torch.log(vb).abs())).sum(-1)
    gap = ((got[rows].double() - ref).abs() / torch.clamp(scale, min=1.0)).max()
    assert float(gap) <= 1e-5
