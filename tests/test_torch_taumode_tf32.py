"""Kernel A's arithmetic and layout, held on the CPU (the kernel itself runs
only on the card; ``tests/test_torch_kernels_gpu.py`` holds it there).

* 3xTF32 — ``taumode_lambdas_3xtf32_plain`` repeats the kernel's
  arithmetic (TF32 rounding to nearest, ties away, by bit mask; each product
  ``hi·hi + hi·lo + lo·hi`` summed in f32). It must stay within 1e-6 ·
  max(|λ|, 1) of the full-f32 plain version, on normal data and on the
  energy data of the main path; one TF32 pass must not (it leaves 1e-5 on
  the energy data, so the kernel may not use it).
* The prepared operand read the way the kernel's fragments read it gives
  the products ``X·W`` (the feature order within a chunk cancels).
* The launch-plan mirror of ``csrc/taumode.cu``: shared memory within the
  card's 232,448 bytes for every F ≤ 2048, and the loader and splits the
  main path's shapes get.
"""

import numpy as np
import pytest
import torch

from matternet_rs_tpu_torch import ArrowSpaceBuilder
from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.ops import laplacian as tlap
from matternet_rs_tpu_torch.ops import taumode as ttm
from matternet_rs_tpu_torch.ops._mm import mm
from matternet_rs_tpu_torch.ops.kernels import taumode as ttk
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

TOL_MIRROR, TOL_LAMBDA = 1e-6, 1e-5


def _rel_gap(got, ref):
    return float(((got - ref).abs() / torch.clamp(ref.abs(), min=1.0)).max())


def _laplacian(f, seed):
    nodes = np.random.default_rng(seed).normal(size=(f, 30)).astype(np.float32)
    gl = tlap.build_laplacian_matrix(torch.from_numpy(nodes),
                                     GraphParams(eps=0.9, k=5, topk=5, sparsity_check=False))
    return gl.matrix.contiguous()


@pytest.fixture(scope="module")
def energy():
    """The main path's data family at 4000 × 128, its λ-graph Laplacian from
    the port's own build (the main path's builder settings) and its τ."""
    X = make_energy_test_dataset(4000, 128, 44).astype(np.float32)
    _, gl = (ArrowSpaceBuilder(device="cpu").with_lambda_graph(1.0, 6).with_sparsity_check(False)
             .with_cluster_params(max_clusters=64, radius=25.0).with_sampling(None).build(X))
    Xt = torch.from_numpy(X)
    return Xt, gl.matrix.float().contiguous(), ttm.select_tau(Xt, ttm.TAU_MEDIAN)


@pytest.mark.parametrize("n,f", [(500, 24), (400, 128), (200, 768), (48, 2048)])
def test_3xtf32_mirror_is_within_1e6_of_the_f32_plain_version(n, f):
    X = np.random.default_rng(f).normal(size=(n, f)).astype(np.float32)
    X[3] = 0.0
    X[5] = 1e-11
    X = torch.from_numpy(X)
    L = _laplacian(f, 6)
    tau = ttm.select_tau(X, ttm.TAU_MEDIAN)
    got = ttk.taumode_lambdas_3xtf32_plain(X, L, tau)
    assert _rel_gap(got, ttk.taumode_lambdas_plain(X, L, tau)) <= TOL_MIRROR
    assert float(got[3]) == 0.0 and float(got[5]) == 0.0


def test_3xtf32_mirror_holds_on_the_energy_data(energy):
    X, L, tau = energy
    assert _rel_gap(ttk.taumode_lambdas_3xtf32_plain(X, L, tau),
                    ttk.taumode_lambdas_plain(X, L, tau)) <= TOL_MIRROR


def test_one_tf32_pass_breaks_the_lambda_tolerance_on_the_energy_data(energy):
    X, L, tau = energy
    one_pass = ttk._lambdas(X, L, tau, lambda a, b: mm(ttk.tf32_round(a), ttk.tf32_round(b)))
    assert _rel_gap(one_pass, ttk.taumode_lambdas_plain(X, L, tau)) > TOL_LAMBDA


def test_tf32_round_is_nearest_with_ties_away_from_zero():
    ulp = 2.0 ** -10                                   # TF32's unit at 1.0
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + 3 * ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23,
                      0.0, -0.0, 3.0e38], dtype=torch.float32)
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0 + 2 * ulp, 1.0, 0.0, -0.0, 3.0e38],
                        dtype=torch.float32)
    got = ttk.tf32_round(x)
    assert torch.equal(got[:6], want[:6]) and torch.signbit(got[5])
    assert float((got[6] - want[6]).abs()) <= 3.0e38 * 2.0 ** -11
    assert torch.equal(ttk.tf32_round(got), got)       # TF32 values are fixed points
    assert bool(torch.all(got.view(torch.int32) & 0x1FFF == 0))


@pytest.mark.parametrize("f", [1, 3, 70, 128])
def test_prepared_operand_read_as_the_kernel_reads_it_gives_the_products(f):
    """One 64-row warpgroup: the operand's tiles unswizzled; for each
    32-wide column tile and K-chunk, lane
    (g, t) of warp w holds rows 16w+g and 16w+g+8 at features 8t+2s and
    8t+2s+1 of step s as the wgmma fragment's slots t and t+4; the step
    reads slots 0..7 of the operand's rows. The sum is X·W of each part."""
    rng = np.random.default_rng(f)
    n, fp = 64, -(-f // 32) * 32
    X = rng.normal(size=(n, f)).astype(np.float64)
    L = torch.from_numpy(rng.normal(size=(f, f)).astype(np.float32))
    A, _, _ = ttk.operator_weights(L)
    nct = fp // 32
    tiles = ttk.prepared_operand(L, A).double().numpy()
    assert tiles.shape == (3, 2, nct, nct, 32, 32)
    # Undo the 16-byte unit swizzle of each row, then lay the tiles out as [n, k].
    r, pos = np.arange(32)[:, None], np.arange(32)[None, :]
    tiles = np.take_along_axis(tiles, np.broadcast_to(((pos // 4) ^ (r % 8)) * 4 + pos % 4,
                                                      tiles.shape), axis=5)
    Wp = tiles.transpose(0, 1, 2, 4, 3, 5).reshape(3, 2, fp, fp)
    Xp = np.zeros((n, fp))
    Xp[:, :f] = X
    g, t = np.arange(32) >> 2, np.arange(32) & 3
    for part, W in enumerate((L, A, A * A)):
        D = np.zeros((n, fp))
        for c in range(fp // 32):
            for kc in range(fp // 32):
                feats = Xp[:, 32 * kc:32 * kc + 32]
                tile = Wp[part, 0] + Wp[part, 1]
                tile = tile[32 * c:32 * c + 32, 32 * kc:32 * kc + 32]
                for s in range(4):
                    frag = np.zeros((n, 8))
                    for w in range(4):
                        for h in range(2):
                            rows = 16 * w + g + 8 * h
                            frag[rows, t] = feats[rows, 8 * t + 2 * s]
                            frag[rows, t + 4] = feats[rows, 8 * t + 2 * s + 1]
                    D[:, 32 * c:32 * c + 32] += frag @ tile[:, 8 * s:8 * s + 8].T
        ref = X @ W.double().numpy()
        assert np.abs(D[:, :f] - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())
        assert not D[:, f:].any()


def test_plan_fits_shared_memory_for_every_width():
    for f in range(1, ttk.MAX_KERNEL_F + 1):
        plan = ttk.taumode_plan(1000, f)
        assert plan["smem_bytes"] <= ttk.MAX_DYNAMIC_SMEM
        assert plan["loader"] == ("tma" if f % 4 == 0 else "elementwise")
    with pytest.raises(ValueError):
        ttk.taumode_plan(1000, ttk.MAX_KERNEL_F + 1)
    with pytest.raises(ValueError):
        ttk.taumode_plan(0, 128)


@pytest.mark.parametrize("n,f,sms,splits,grid", [
    (1_000_000, 128, 132, 1, 132),        # the main path: 7,813 row tiles fill 59 waves and a bit
    (40_000, 768, 132, 2, 132),           # the wide build: 313 tiles fill 79% of 3 waves, 626 items 95% of 5
    (65, 2048, 132, 8, 8),                # one row tile: split as far as allowed
    (1, 3, 132, 1, 1),                    # one column tile: nothing to split
    (128 * 132, 128, 132, 1, 132),
])
def test_plan_splits_and_grid(n, f, sms, splits, grid):
    plan = ttk.taumode_plan(n, f, sms=sms)
    assert (plan["splits"], plan["grid"]) == (splits, grid)
    assert ttk.taumode_plan(n, f, aligned=False, sms=sms)["loader"] == "elementwise"


def test_split_counts_leave_no_item_without_columns():
    for f in range(1, ttk.MAX_KERNEL_F + 1, 7):
        nct = -(-f // 32)
        for n in (1, 200, 5000, 40_000):
            s = ttk.taumode_plan(n, f)["splits"]
            cpt = -(-nct // s)
            assert 1 <= s <= min(ttk.MAX_SPLITS, nct) and -(-nct // cpt) == s


@pytest.mark.parametrize("f", [3, 24, 128])
def test_both_forms_stay_within_their_rounding_bound_of_the_exact_value(f):
    """At F = 3 a row with nearly equal features makes the expanded sums
    cancel: the float32 closed form itself then misses the float64 one by
    more than 1e-5. Both float32 forms stay within 1e-5·max(|λ|, 1) plus
    the row's first-order rounding bound (products of relative error 2^-22
    for float32, 2^-20 for 3xTF32) of the exact value; at F ≥ 24 that bound
    is far below 1e-5."""
    X = torch.from_numpy(np.random.default_rng(11 + f).normal(size=(1000, f)).astype(np.float32))
    L = _laplacian(f, 5)
    tau = ttm.select_tau(X, ttm.TAU_MEDIAN)
    exact = ttk.taumode_lambdas_f64(X, L, tau)
    scale = torch.clamp(exact.abs(), min=1.0)
    for got, eps in ((ttk.taumode_lambdas_plain(X, L, tau), 2.0 ** -22),
                     (ttk.taumode_lambdas_3xtf32_plain(X, L, tau), 2.0 ** -20)):
        bound = ttk.taumode_rounding_bound(X, L, tau, eps)
        assert bool(torch.all((got.double() - exact).abs() <= TOL_LAMBDA * scale + bound))
        assert (float(bound.max()) > TOL_LAMBDA) == (f == 3)
    plain_gap = float(((ttk.taumode_lambdas_plain(X, L, tau).double() - exact).abs() / scale).max())
    assert (plain_gap > TOL_LAMBDA) == (f == 3)
