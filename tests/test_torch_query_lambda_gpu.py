"""The query kernel (``mrs_taumode_query`` in ``csrc/taumode.cu``) on the
card: τ, the closed form and the fold by the index's min and range in one
launch.

* Against its plain version (``taumode_query_lambdas_plain``) and the
  float64 closed form for B in {1, 7, 256, 1024, 32,767}, F in {1, 3, 96,
  128, 130, ``MAX_QUERY_F``} and the four τ modes, on rows with a zero
  row, a row below the zero threshold, tied features and nearly equal
  features: raw λ within 1e-6·max(|λ|, 1) plus the row's first-order
  rounding bound (products of relative error 2·(F + 4)·2⁻²⁴: a sequential
  f32 sum over F features, then over F columns; the plain version is held
  to the same allowance), plus, for τ = mean, the mean's own rounding
  (|∂λ/∂τ| ≤ 1). Zero rows score 0 exactly.
* The fold: ``clamp((raw − mn) / rng, 0, 1)`` bit for bit torch's on the
  kernel's raw with mn and rng as device scalars; batches the kernel cuts
  into 1, 2, 4 and 8 rows a block give the same bits.
* Through ``search_batch`` (exact and ``bf16x3_rescored``, B = 256 on a
  65,536 × 128 index): one ``taumode_query`` launch a call, no kernel A,
  no matrix product or sort under ``search.query_lambda``, the span's
  ``route`` attr ``"kernel"``, and 3 syncs in the call's tree (the
  queries' upload, the two results' copies); ids equal to the closed-form
  route's except at near ties (``utils/parity.topk_mismatches``; the
  rescored tier at the same k, ``same_k_mismatches``).

Every test needs a CUDA card and ``nvcc`` (marker ``gpu``) and skips
without them. This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_query_lambda_gpu.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from matternet_rs_tpu_torch import backend
from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder
from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops import laplacian as tlap
from matternet_rs_tpu_torch.ops import taumode as ttm
from matternet_rs_tpu_torch.ops.kernels import taumode as ttk
from matternet_rs_tpu_torch.utils import profiling
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset
from matternet_rs_tpu_torch.utils.parity import same_k_mismatches, topk_mismatches

pytestmark = pytest.mark.gpu

B_CASES = (1, 7, 256, 1024, 32_767)
F_CASES = (1, 3, 96, 128, 130, ttk.MAX_QUERY_F)
MODES = [(ttm.TAU_FIXED, 0.4), (ttm.TAU_MEDIAN, 0.0), (ttm.TAU_MEAN, 0.0),
         (ttm.TAU_PERCENTILE, 0.3)]
MODE_IDS = ["fixed", "median", "mean", "percentile"]
MN, RNG = 0.0123456789, 0.876543219
U = 2.0 ** -24
TOL = 1e-6
N, F, B, K = 65_536, 128, 256, 10


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if backend.nvcc_path() is None:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _laplacian(f, dev):
    if f == 1:                            # a graph needs two nodes; one feature takes L = [[0.7]]
        return torch.full((1, 1), 0.7, device=dev)
    nodes = np.random.default_rng(f).normal(size=(f, 30)).astype(np.float32)
    gl = tlap.build_laplacian_matrix(torch.from_numpy(nodes).to(dev),
                                     GraphParams(eps=0.9, k=5, topk=5, sparsity_check=False))
    return gl.matrix.float().contiguous()


def _rows(b, f, seed, dev):
    """Normal rows; where B allows, a zero row, a row below the zero
    threshold, a row of tied features and one of nearly equal features."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b, f)).astype(np.float32)
    specials = [r for r in (b // 3, b // 2, b - 2, b - 1) if r > 0][: 4]
    if len(set(specials)) == 4:
        X[specials[0]] = 0.0
        X[specials[1]] = 1e-11
        X[specials[2]] = rng.choice(np.array([-1.0, 0.0, 0.5], np.float32), size=f)
        X[specials[3]] = 1.0 + 1e-7 * rng.normal(size=f)
    return torch.from_numpy(X).to(dev), specials[:2] if len(set(specials)) == 4 else []


def _held(X, L, mode, param, raw):
    """How far ``raw`` lies from the float64 closed form, as a share of its
    allowance (≤ 1 passes), and that closed form."""
    f = X.shape[1]
    tau = ttm.select_tau(X, mode, param)
    exact = ttk.taumode_lambdas_f64(X, L, tau)
    scale = TOL * torch.clamp(exact.abs(), min=1.0)
    # τ = mean: the kernel's mean and torch's each within (F + 2)·2⁻²⁴·mean|x|.
    d_tau = 2 * (f + 2) * U * X.double().abs().mean(dim=1) if mode == ttm.TAU_MEAN else 0.0
    allow = scale + ttk.taumode_rounding_bound(X, L, tau, 2 * (f + 4) * U) + d_tau
    return float(((raw.double() - exact).abs() / allow).max()), exact


@pytest.mark.parametrize("mode,param", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("f", F_CASES)
def test_kernel_matches_plain_and_float64(dev, f, mode, param):
    L = _laplacian(f, dev)
    for b in B_CASES:
        X, zero_rows = _rows(b, f, 100 * f + b, dev)
        before = kernels.launch_counts()["taumode_query"]
        raw, q = ttk.taumode_query_lambdas(X, L, mode, param, MN, RNG)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["taumode_query"] == before + 1
        raw_p, q_p = ttk.taumode_query_lambdas_plain(X, L, mode, param, MN, RNG)
        over, exact = _held(X, L, mode, param, raw)
        assert over <= 1.0, f"B={b} F={f}: kernel {over:.3g}× its allowance from float64"
        over_p, _ = _held(X, L, mode, param, raw_p)
        assert over_p <= 1.0, f"B={b} F={f}: plain {over_p:.3g}× the allowance from float64"
        for r in zero_rows:
            assert float(raw[r]) == 0.0 and float(q[r]) == float(q_p[r])
        mn_t = torch.tensor(MN, dtype=torch.float32, device=dev)
        rng_t = torch.tensor(RNG, dtype=torch.float32, device=dev)
        fold = torch.clamp((raw - mn_t) / rng_t, 0.0, 1.0)
        assert torch.equal(q.view(torch.int32), fold.view(torch.int32))


@pytest.mark.parametrize("f", [3, 96, 128, 130, ttk.MAX_QUERY_F])
def test_rows_a_block_leave_the_bits_alone(dev, f):
    """Each row's sums run in one order whatever rows a block holds: the
    first rows of batches that the kernel cuts into 1, 2, 4 and 8 rows a
    block come out bit for bit alike."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sizes = (2 * sms, 4 * sms, 8 * sms, 16 * sms + 8)
    L = _laplacian(f, dev)
    X, _ = _rows(sizes[-1], f, 7 + f, dev)
    assert [ttk.taumode_query_plan_chosen(n, f)["rows"] for n in sizes] == [1, 2, 4, 8]
    for mode, param in MODES:
        outs = [ttk.taumode_query_lambdas(X[:n], L, mode, param, MN, RNG) for n in sizes]
        for raw, q in outs[1:]:
            assert torch.equal(raw[:sizes[0]].view(torch.int32), outs[0][0].view(torch.int32))
            assert torch.equal(q[:sizes[0]].view(torch.int32), outs[0][1].view(torch.int32))
    plan = ttk.taumode_query_plan_chosen(sizes[-1], f)
    assert plan["threads"] % 32 == 0 and plan["threads"] >= f and plan["smem_bytes"] <= 232_448


def test_kernel_refuses_what_it_cannot_take(dev):
    L = _laplacian(96, dev)
    X, _ = _rows(8, 96, 1, dev)
    with pytest.raises(ValueError):
        ttk.taumode_query_lambdas(X, L[:95, :95].contiguous(), ttm.TAU_MEDIAN, 0.0, MN, RNG)
    with pytest.raises(ValueError):
        ttk.taumode_query_lambdas(X.double(), L, ttm.TAU_MEDIAN, 0.0, MN, RNG)
    with pytest.raises(ValueError):
        ttk.taumode_query_lambdas(X, L, 7, 0.0, MN, RNG)
    wide = _laplacian(ttk.MAX_QUERY_F + 1, dev)
    with pytest.raises(ValueError):
        ttk.taumode_query_lambdas(torch.ones(4, ttk.MAX_QUERY_F + 1, device=dev), wide,
                                  ttm.TAU_MEDIAN, 0.0, MN, RNG)
    raw, q = ttk.taumode_query_lambdas(X[:0], L, ttm.TAU_MEDIAN, 0.0, MN, RNG)
    assert raw.shape == q.shape == (0,)


@pytest.fixture(scope="module")
def index(dev):
    data = make_energy_test_dataset(N, F, seed=43).astype(np.float32)
    rng = np.random.default_rng(5)
    Q = (data[rng.choice(N, B, replace=False)]
         + 0.01 * rng.standard_normal((B, F))).astype(np.float32)
    aspace, gl = (ArrowSpaceBuilder().with_lambda_graph(1.0, 6).with_sparsity_check(False)
                  .with_cluster_params(max_clusters=64, radius=25.0).with_sampling(None)
                  .build(data))
    for tier in (False, "bf16x3_rescored"):          # first-use copies and builds
        aspace.search_batch(Q, gl, K, 0.7, quantized=tier)
    torch.cuda.synchronize()
    return aspace, gl, Q


def _under(prof, name):
    """Names of the profiler's events nested under the event ``name``."""
    out = []
    for e in prof.events():
        p = e.cpu_parent
        while p is not None and p.name != name:
            p = p.cpu_parent
        if p is not None:
            out.append(e.name)
    return out


@pytest.mark.parametrize("tier", [False, "bf16x3_rescored"], ids=["exact", "bf16x3"])
def test_search_batch_takes_one_launch_and_three_syncs(index, tier):
    aspace, gl, Q = index
    torch.cuda.synchronize()
    kernels.reset_launches()
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        aspace.search_batch(Q, gl, K, 0.7, quantized=tier)
    counts = kernels.launch_counts()
    assert counts["taumode_query"] == 1 and counts["taumode"] == 0, counts
    spans = profiling.spans()
    (root,) = [s for s in spans if s.name == "search.batch"]
    tree = [s for s in spans if s.root == root.id]
    (ql,) = [s for s in tree if s.name == "search.query_lambda"]
    assert ql.attrs == {"route": "kernel"} and ql.syncs == 0
    assert sum(s.syncs for s in tree) == 3, {s.name: s.syncs for s in tree}
    inside = _under(prof, "search.query_lambda")
    assert not [n for n in inside if n in ("aten::mm", "aten::matmul", "aten::addmm",
                                            "aten::bmm", "aten::sort")], inside


@pytest.mark.parametrize("tier", [False, "bf16x3_rescored"], ids=["exact", "bf16x3"])
def test_ids_match_the_closed_form_route_except_at_near_ties(index, monkeypatch, tier):
    aspace, gl, Q = index
    ids, sc = aspace.search_batch(Q, gl, K, 0.7, quantized=tier)
    monkeypatch.setattr(ttm, "query_route", lambda X, L: "closed")
    if tier:                       # the rescored tiers' slabs depend on k: compare at k
        ref_ids, ref_sc = aspace.search_batch(Q, gl, K, 0.7, quantized=tier)
        assert not same_k_mismatches(ref_ids, ref_sc, ids, sc)
    else:
        ref_ids, ref_sc = aspace.search_batch(Q, gl, K + 1, 0.7, quantized=tier)
        assert not topk_mismatches(ref_ids, ref_sc, ids, sc)
