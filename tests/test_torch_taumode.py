"""Port vs reference: τ selection, the closed-form λ and kernel A's plain
version (against the Pallas kernels in interpret mode).

Tolerance for λ: |Δλ| ≤ 1e-5·max(1, |λ|) — the two packages sum the same
f32 products in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu.graph import GraphParams as JGraphParams
from matternet_rs_tpu.ops import laplacian as jlap
from matternet_rs_tpu.ops import taumode as jtm
from matternet_rs_tpu.ops.pallas import taumode_fused as jtf

from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops import taumode as ttm
from matternet_rs_tpu_torch.ops.kernels import taumode as ttk


def _graph(f, seed=0):
    rng = np.random.default_rng(seed)
    nodes = rng.normal(size=(f, 30)).astype(np.float32)
    L = jlap.build_laplacian_matrix(
        nodes, JGraphParams(eps=0.9, k=5, topk=5, sparsity_check=False)
    ).matrix
    return np.array(L)


def _rows(n, f, seed):
    X = np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)
    X[3] = 0.0          # zero row
    X[5] = 1e-11        # below the zero-row guard in both kernels
    return X


def _assert_lambda_close(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert np.all(np.abs(ref - got) <= 1e-5 * np.maximum(1.0, np.abs(ref)))


MODES = [
    (ttm.TAU_FIXED, 0.3), (ttm.TAU_MEDIAN, 0.0), (ttm.TAU_MEAN, 0.0),
    (ttm.TAU_PERCENTILE, 0.37),
]


@pytest.mark.parametrize("mode,param", MODES)
@pytest.mark.parametrize("f", [31, 32])
def test_select_tau_matches_reference(mode, param, f):
    X = np.random.default_rng(f).normal(size=(64, f)).astype(np.float32)
    ref = np.asarray(jtm.select_tau(jnp.asarray(X), mode, param))
    got = ttm.select_tau(torch.from_numpy(X), mode, param).numpy()
    if mode == ttm.TAU_MEAN:
        assert np.allclose(ref, got, rtol=1e-6, atol=1e-7)
    else:
        assert np.array_equal(ref, got)


def test_median_averages_middle_pair_for_even_f():
    v = torch.tensor([[4.0, 1.0, 3.0, 2.0]])
    assert float(ttm.select_tau(v, ttm.TAU_MEDIAN)[0]) == 2.5
    assert float(torch.median(v)) == 2.0     # the hazard the sort avoids


def test_percentile_index_rounds_half_up():
    v = torch.arange(1.0, 6.0)[None, :]      # F = 5: (F-1)·0.375 + 0.5 = 2.0
    assert float(ttm.select_tau(v, ttm.TAU_PERCENTILE, 0.375)[0]) == 3.0
    assert float(ttm.select_tau(v, ttm.TAU_PERCENTILE, 0.36)[0]) == 2.0


@pytest.mark.parametrize("mode,param", MODES)
@pytest.mark.parametrize("n,f", [(300, 24), (256, 128), (1000, 60)])
def test_closed_form_matches_reference(mode, param, n, f):
    L = _graph(f)
    X = _rows(n, f, seed=1)
    ref = jtm.taumode_lambdas(jnp.asarray(X), jnp.asarray(L), mode, param)
    got = ttm.taumode_lambdas(torch.from_numpy(X), torch.from_numpy(L), mode, param)
    _assert_lambda_close(ref, got)
    assert float(got[3]) == 0.0 and float(got[5]) == 0.0


@pytest.mark.parametrize("n,f", [(300, 24), (256, 128)])
def test_kernel_plain_matches_pallas_kernel(n, f):
    L = _graph(f, seed=2)
    X = _rows(n, f, seed=3)
    tau = jtm.select_tau(jnp.asarray(X), jtm.TAU_MEDIAN)
    ref = jtf.taumode_lambdas_pallas(jnp.asarray(X), jnp.asarray(L), tau, interpret=True)
    got = ttk.taumode_lambdas_plain(
        torch.from_numpy(X), torch.from_numpy(L), torch.from_numpy(np.array(tau))
    )
    _assert_lambda_close(ref, got)
    assert float(got[3]) == 0.0 and float(got[5]) == 0.0 == float(ref[5])


@pytest.mark.parametrize("n,f", [(300, 384), (512, 300)])
def test_kernel_plain_matches_pallas_bigf_kernel(n, f):
    L = _graph(f, seed=8)
    X = _rows(n, f, seed=9)
    tau = jtm.select_tau(jnp.asarray(X), jtm.TAU_MEDIAN)
    ref = jtf.taumode_lambdas_pallas_bigf(
        jnp.asarray(X), jnp.asarray(L), tau, interpret=True
    )
    got = ttk.taumode_lambdas_plain(
        torch.from_numpy(X), torch.from_numpy(L), torch.from_numpy(np.array(tau))
    )
    _assert_lambda_close(ref, got)
    assert float(got[5]) == 0.0 == float(ref[5])


def test_auto_routes_large_n_through_kernel_plain_on_cpu():
    """From 32768 rows the auto route is kernel A's; on the CPU that is its
    plain version, equal to the closed form and launching nothing."""
    L = _graph(16, seed=4)
    X = _rows(ttm.KERNEL_MIN_N, 16, seed=5)
    kernels.reset_launches()
    got = ttm.taumode_lambdas_auto(torch.from_numpy(X), torch.from_numpy(L))
    ref = jtm.taumode_lambdas_auto(jnp.asarray(X), jnp.asarray(L))
    _assert_lambda_close(ref, got)
    assert kernels.launch_counts()["taumode"] == 0


def test_auto_raises_for_the_unported_sparse_route():
    """The sparse route beyond ``SPARSE_F_THRESHOLD`` is ported: where this
    call once raised ``NotImplementedError`` it now returns λ (a zero row
    against a zero graph scores 0; a ring graph matches the closed form)."""
    assert torch.equal(ttm.taumode_lambdas_auto(torch.zeros(2, 2049), torch.zeros(2049, 2049)),
                       torch.zeros(2))
    f = ttm.SPARSE_F_THRESHOLD + 1
    ring = torch.arange(f)
    W = torch.zeros(f, f)
    W[ring, (ring + 1) % f] = 0.5
    W = torch.maximum(W, W.T)
    L = torch.diag(W.sum(dim=1)) - W
    X = torch.from_numpy(np.random.default_rng(3).normal(size=(5, f)).astype(np.float32))
    assert np.allclose(ttm.taumode_lambdas_auto(X, L).numpy(), ttm.taumode_lambdas(X, L).numpy(),
                       atol=1e-6)
