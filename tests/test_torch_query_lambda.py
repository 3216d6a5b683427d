"""The query λ (``ops/taumode.query_lambdas``) on the CPU.

* The route by shape and device (``query_route``): a CUDA batch below
  ``KERNEL_MIN_N`` rows with F ≤ ``MAX_QUERY_F`` takes the query kernel;
  the CPU and F past the limit keep the closed form, an ELL graph and F
  past ``SPARSE_F_THRESHOLD`` the sparse route, ``KERNEL_MIN_N`` rows
  kernel A.
* On the CPU every route returns bit for bit what the entry computed
  before the query kernel: ``taumode_lambdas_auto``, then the fold by
  ``mn`` and ``rng`` made as float32 device scalars — the four τ modes,
  odd and even F, a JL-projected index through ``search_batch``, an ELL
  graph, a zero row; the fold on host floats of the IVF and streaming
  sites too.
* ``taumode_query_lambdas_plain``, the kernel's plain version, against
  the float64 closed form within 1e-6·max(|λ|, 1) plus the row's first-order
  rounding bound.
* The kernel's order statistics by rank counting (a numpy model of its
  rule) give the value ``torch.sort`` leaves at the rank, ties and NaN
  included (−0 and +0 compare equal: either may stand at their ranks).
* ``core._alpha_vector`` gives the values it gave when it copied the
  scalar to the device and read it back, for float, int, numpy and 0-d
  tensor alphas.

The kernel itself runs on the card only (``test_torch_query_lambda_gpu.py``).
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from matternet_rs_tpu_torch import core
from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder
from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops import laplacian as tlap
from matternet_rs_tpu_torch.ops import taumode as ttm
from matternet_rs_tpu_torch.ops.csr import ell_from_dense_laplacian
from matternet_rs_tpu_torch.ops.kernels import taumode as ttk
from matternet_rs_tpu_torch.utils import profiling
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

MODES = [(ttm.TAU_FIXED, 0.4), (ttm.TAU_MEDIAN, 0.0), (ttm.TAU_MEAN, 0.0),
         (ttm.TAU_PERCENTILE, 0.3)]
MODE_IDS = ["fixed", "median", "mean", "percentile"]
MN, RNG = 0.0123456789, 0.876543219


def _laplacian(f, seed):
    nodes = np.random.default_rng(seed).normal(size=(f, 30)).astype(np.float32)
    gl = tlap.build_laplacian_matrix(torch.from_numpy(nodes),
                                     GraphParams(eps=0.9, k=5, topk=5, sparsity_check=False))
    return gl.matrix.float().contiguous()


def _rows(n, f, seed):
    X = np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)
    X[1] = 0.0
    X[2] = 1e-11
    return torch.from_numpy(X)


def _old(X, L, mode, param, mn, rng):
    """What the entry computed before: the routed raw λ, then the fold by
    float32 scalars copied to the device."""
    raw = ttm.taumode_lambdas_auto(X, L, mode, param)
    mn_t = torch.tensor(mn, dtype=torch.float32, device=raw.device)
    rng_t = torch.tensor(rng, dtype=torch.float32, device=raw.device)
    return raw, torch.clamp((raw - mn_t) / rng_t, 0.0, 1.0)


def _shaped(n, f, device):
    """A stand-in with a batch's shape and device: the route reads no more."""
    return types.SimpleNamespace(shape=(n, f), device=torch.device(device))


@pytest.mark.parametrize("n,f,device,route", [
    (256, 128, "cuda", "kernel"),
    (1024, 96, "cuda", "kernel"),
    (1, 1, "cuda", "kernel"),
    (32_767, ttk.MAX_QUERY_F, "cuda", "kernel"),
    (256, 128, "cpu", "closed"),
    (1024, 96, "cpu", "closed"),
    (256, ttk.MAX_QUERY_F + 1, "cuda", "closed"),
    (1024, 768, "cuda", "closed"),
    (256, ttm.SPARSE_F_THRESHOLD + 1, "cuda", "ell"),
    (256, ttm.SPARSE_F_THRESHOLD + 1, "cpu", "ell"),
    (ttm.KERNEL_MIN_N, 128, "cuda", "kernel_a"),
    (ttm.KERNEL_MIN_N, 128, "cpu", "kernel_a"),
])
def test_route_follows_shape_and_device(n, f, device, route):
    assert ttk.MAX_QUERY_F >= 128
    assert ttm.query_route(_shaped(n, f, device), None) == route


def test_route_takes_an_ell_graph_and_a_corpus_size():
    L = _laplacian(16, 1)
    ell = ell_from_dense_laplacian(L)
    assert ttm.query_route(_shaped(256, 16, "cuda"), ell) == "ell"
    assert ttm.query_route(_shaped(256, 16, "cuda"), L) == "kernel"
    assert ttm.query_route(_shaped(ttm.KERNEL_MIN_N, 16, "cuda"), L) == "kernel_a"
    assert ttm.query_route(_shaped(ttm.KERNEL_MIN_N - 1, 16, "cuda"), L) == "kernel"


@pytest.mark.parametrize("f", [7, 8, 128])
@pytest.mark.parametrize("mode,param", MODES, ids=MODE_IDS)
def test_cpu_result_is_the_old_composition_bit_for_bit(f, mode, param):
    X, L = _rows(300, f, f), _laplacian(f, 2)
    kernels.reset_launches()
    raw, q, route = ttm.query_lambdas(X, L, mode, param, MN, RNG)
    assert route == "closed"
    raw_old, q_old = _old(X, L, mode, param, MN, RNG)
    assert torch.equal(raw, raw_old) and torch.equal(q, q_old)
    assert float(raw[1]) == 0.0 and float(raw[2]) == 0.0
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}
    # The IVF and streaming sites folded with host floats: the same bits.
    assert torch.equal(torch.clamp((raw_old - MN) / RNG, 0.0, 1.0), q_old)


@pytest.mark.parametrize("mode,param", MODES, ids=MODE_IDS)
def test_cpu_result_on_an_ell_graph_and_from_kernel_a_rows(mode, param):
    X, L = _rows(200, 24, 5), _laplacian(24, 3)
    ell = ell_from_dense_laplacian(L)
    raw, q, route = ttm.query_lambdas(X, ell, mode, param, MN, RNG)
    raw_old, q_old = _old(X, ell, mode, param, MN, RNG)
    assert route == "ell" and torch.equal(raw, raw_old) and torch.equal(q, q_old)
    Xa = X.repeat(ttm.KERNEL_MIN_N // X.shape[0] + 1, 1)[:ttm.KERNEL_MIN_N]
    raw, q, route = ttm.query_lambdas(Xa, L, mode, param, MN, RNG)
    raw_old, q_old = _old(Xa, L, mode, param, MN, RNG)
    assert route == "kernel_a" and torch.equal(raw, raw_old) and torch.equal(q, q_old)


def test_fold_on_host_floats_is_the_device_scalar_fold():
    """Over 2²⁰ random raw values and awkward mn/rng, the fold by host
    floats (``fold_lambdas``, and ``(raw − mn) / rng`` with Python floats)
    equals the fold by float32 device scalars, bit for bit, on the CPU."""
    g = torch.Generator().manual_seed(7)
    raw = torch.rand(1 << 20, generator=g) * 3.0 - 1.0
    raw[:4] = torch.tensor([0.0, -0.0, 1.0, float("nan")])
    for mn, rng in ((MN, RNG), (1 / 3, 2 / 3), (0.0, 1.0), (-0.25, 1e-7), (0.5, 0.0)):
        old = torch.clamp((raw - torch.tensor(mn, dtype=torch.float32))
                          / torch.tensor(rng, dtype=torch.float32), 0.0, 1.0)
        for got in (ttk.fold_lambdas(raw, mn, rng), torch.clamp((raw - mn) / rng, 0.0, 1.0)):
            assert torch.equal(got.view(torch.int32), old.view(torch.int32)), (mn, rng)


@pytest.fixture(scope="module")
def jl_index():
    data = make_energy_test_dataset(900, 160, seed=5).astype(np.float32)
    aspace, gl = (ArrowSpaceBuilder(device="cpu").with_lambda_graph(1.0, 5)
                  .with_sparsity_check(False).with_cluster_params(max_clusters=20, radius=120.0)
                  .with_dims_reduction(True, 0.5).with_seed(9).build(data))
    rng = np.random.default_rng(4)
    Q = (data[rng.choice(len(data), 9, replace=False)]
         + 0.01 * rng.standard_normal((9, data.shape[1]))).astype(np.float32)
    return aspace, gl, Q


def test_jl_projected_search_takes_the_old_query_lambda(jl_index):
    aspace, gl, Q = jl_index
    graph = aspace.graph_for_taumode(gl)
    Qt = torch.from_numpy(Q)
    assert aspace._projects(Qt, graph) and graph.shape[0] < Q.shape[1]
    _, _, raw = aspace.search_batch(Q, gl, 5, 0.7, return_raw=True)
    raw_old, _ = _old(aspace.projection.project(Qt), graph, aspace.taumode.mode,
                      aspace.taumode.param, aspace.min_lambdas, aspace.range_lambdas)
    assert np.array_equal(raw, raw_old.numpy())


def test_search_batch_names_the_route_on_its_span(jl_index):
    aspace, gl, Q = jl_index
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        aspace.search_batch(Q, gl, 5, 0.7)
    spans = [s for s in profiling.spans() if s.name == "search.query_lambda"]
    assert [s.attrs for s in spans] == [{"route": "closed"}]


@pytest.mark.parametrize("f", [3, 24, 128, 768])
@pytest.mark.parametrize("mode,param", MODES, ids=MODE_IDS)
def test_plain_version_is_held_to_the_float64_closed_form(f, mode, param):
    X, L = _rows(400, f, 20 + f), _laplacian(f, 6)
    raw, q = ttk.taumode_query_lambdas_plain(X, L, mode, param, MN, RNG)
    tau = ttm.select_tau(X, mode, param)
    exact = ttk.taumode_lambdas_f64(X, L, tau)
    bound = ttk.taumode_rounding_bound(X, L, tau, 2.0 ** -22)
    assert bool(torch.all((raw.double() - exact).abs()
                          <= 1e-6 * torch.clamp(exact.abs(), min=1.0) + bound))
    assert torch.equal(q, ttk.fold_lambdas(raw, MN, RNG))


def _rank_value(row, k):
    """The query kernel's order statistic: the largest value with at most
    k smaller ones, NaN counting as larger than every number (its count
    of smaller values is the row's count of numbers)."""
    numbers = int(np.sum(~np.isnan(row)))
    best = None
    for v in row:
        less = numbers if np.isnan(v) else int(np.sum(row < v))
        if less <= k and (best is None or np.isnan(v) or (not np.isnan(best) and v > best)):
            best = v
    return best


@pytest.mark.parametrize("seed", range(12))
def test_rank_counting_gives_torchs_sorted_value(seed):
    rng = np.random.default_rng(seed)
    f = int(rng.integers(1, 40))
    row = rng.choice(np.array([-1.5, -0.0, 0.0, 0.25, 0.25000003, 2.0], np.float32), size=f)
    if seed % 3 == 0:
        row = rng.normal(size=f).astype(np.float32)
    if seed % 4 == 1:
        row[rng.integers(0, f)] = np.nan
    s = torch.sort(torch.from_numpy(row)).values.numpy()
    for k in range(f):
        got, want = _rank_value(row, k), s[k]
        assert (np.isnan(got) and np.isnan(want)) or got == want, (row, k)
    for mode, param in MODES[1::2] + [(ttm.TAU_PERCENTILE, 0.95), (ttm.TAU_PERCENTILE, 0.0)]:
        k0, k1 = ttk.tau_ranks(f, mode, param)
        v = _rank_value(row, k0) if k0 == k1 else (_rank_value(row, k0) + _rank_value(row, k1)) * np.float32(0.5)
        tau = ttm.select_tau(torch.from_numpy(row)[None], mode, param)[0]
        want = np.float32(max(v, ttm.TAU_FLOOR)) if not np.isnan(v) else v
        assert (np.isnan(want) and bool(torch.isnan(tau))) or float(tau) == float(want)


def _old_alpha_vector(alpha, b_pad, device):
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    if a.ndim == 0:
        return torch.full((b_pad,), float(a), dtype=torch.float32, device=device)
    return torch.nn.functional.pad(a, (0, b_pad - a.shape[0])) if a.shape[0] != b_pad else a


@pytest.mark.parametrize("alpha", [0.7, 1, 0, 0.1 + 0.2, np.float64(0.3), np.float32(0.7),
                                   np.array(0.45), torch.tensor(0.55), torch.tensor(0.55, dtype=torch.float64),
                                   np.int64(1), [0.1, 0.9, 0.3]],
                         ids=["float", "int1", "int0", "inexact", "np64", "np32", "np0d",
                              "tensor0d", "tensor0d64", "npint", "list"])
def test_alpha_vector_gives_the_old_values(alpha):
    got = core._alpha_vector(alpha, 4, "cpu")
    want = _old_alpha_vector(alpha, 4, "cpu")
    assert got.dtype == torch.float32 and torch.equal(got, want)
