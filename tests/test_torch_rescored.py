"""Port vs reference: the quantised search tiers. The int8 sketch, kernel
D's and kernel E's plain versions against the Pallas kernels in interpret
mode, the maxima-first route end to end, and ``search_batch`` for every
tier on a built index — 40,000 × 128 (the maxima-first route) and
3,000 × 128 (the pool-cut fallback).

The reference's maxima-first route is forced on the CPU by running its
Pallas kernels in interpret mode and replacing the TPU-platform gate of
``tilemax_only_supported`` with its shape checks (module fixture below).

Tolerances:

* sketch: the int8 values bit for bit; the dequant multiplier bit for bit
  where the row norms' f32 sums are exact, else within 2 ulp (XLA and
  PyTorch sum a row in different orders);
* sub-tile maxima: 2e-6 abs (the reference's own kernel tolerance: the
  two sum the same bf16 products in different orders);
* slab dots: 1e-5·‖q‖·‖x‖ (1e-5 on the cosine scale);
* search results: ids and exact scores under the same-k rule of
  ``utils/parity.same_k_mismatches`` (scores position by position within
  1e-5; an id may differ only where the scores there agree).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu import builder as jbuilder
from matternet_rs_tpu.core import _quantize_rows_device_jit
from matternet_rs_tpu.ops import search as jso
from matternet_rs_tpu.ops.pallas import tilemax_fused as jtmf

from matternet_rs_tpu_torch import convert
from matternet_rs_tpu_torch import core as tcore
from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops import search as tso
from matternet_rs_tpu_torch.ops.kernels import rescored as rsk
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset
from matternet_rs_tpu_torch.utils.parity import same_k_mismatches

K = 10


@pytest.fixture(scope="module", autouse=True)
def reference_rescored_in_interpret_mode():
    """Route the reference's maxima-first pipeline through interpret-mode
    Pallas on the CPU: the kernels in interpret mode, the TPU-platform gate
    of ``tilemax_only_supported`` replaced by its shape-only checks."""
    def cpu_tilemax_only_supported(nn, ff, bb, tile, subs=jtmf.SUBS):
        return (
            nn >= tile and ff <= jtmf.MAX_FUSED_F_WIDE
            and jtmf.MIN_FUSED_B <= bb <= jtmf.MAX_FUSED_B
            and tile % (subs * 128) == 0
        )

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtmf, "tilemax_only", functools.partial(jtmf.tilemax_only, interpret=True))
        mp.setattr(jtmf, "slab_dots_ring", functools.partial(jtmf.slab_dots_ring, interpret=True))
        mp.setattr(jtmf, "tilemax_only_supported", cpu_tilemax_only_supported)
        yield


def _fixture(n, f, b, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f), dtype=np.float32)
    X[3] = 0.0                                 # exercises the zero-norm guards
    norms = np.sqrt(np.sum(X * X, axis=1)).astype(np.float32)
    lams = rng.random(n, dtype=np.float32)
    Q = rng.standard_normal((b, f), dtype=np.float32)
    ql = rng.random(b, dtype=np.float32)
    al = rng.uniform(0.3, 0.9, b).astype(np.float32)
    return X, norms, lams, Q, ql, al


def _jax(arrs):
    return [jnp.asarray(a) for a in arrs]


def _torch(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _scan_corpora(X):
    """Scan corpus and ``rn`` per mode, for both packages."""
    q8, mult = _quantize_rows_device_jit(jnp.asarray(X))
    tq8, tmult = tcore.quantize_rows(torch.from_numpy(X))
    return {
        "bf16": ((jnp.asarray(X).astype(jnp.bfloat16), None),
                 (torch.from_numpy(X).to(torch.bfloat16), None)),
        "int8": ((q8, mult), (tq8, tmult)),
        "f32": ((jnp.asarray(X), None), (torch.from_numpy(X), None)),
    }


@pytest.mark.parametrize("grid", [True, False], ids=["exact-norms", "normal"])
def test_quantize_rows_matches_reference(grid):
    """On a grid of eighths the squared norms sum exactly in any order, so
    the multiplier must match bit for bit; on normal data only the norm's
    summation order differs (XLA sums 32-wide windows), ≤ 2 ulp."""
    rng = np.random.default_rng(4)
    if grid:
        X = (rng.integers(-50, 51, (300, 48)) / 8.0).astype(np.float32)
    else:
        X = (rng.standard_normal((300, 48)) * rng.uniform(0.01, 50, (300, 1))).astype(np.float32)
    X[7] = 0.0                                                   # zero row
    X[9] = 0.0
    X[9, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]               # scale 1: exact .5 ties
    ref_q8, ref_mult = (np.asarray(a) for a in _quantize_rows_device_jit(jnp.asarray(X)))
    q8, mult = tcore.quantize_rows(torch.from_numpy(X))
    assert q8.dtype == torch.int8 and mult.dtype == torch.float32
    assert np.array_equal(ref_q8, q8.numpy())
    if grid:
        assert np.array_equal(ref_mult, mult.numpy())
    else:
        np.testing.assert_array_max_ulp(ref_mult, mult.numpy(), maxulp=2)
    assert q8[9, :6].tolist() == [127, 0, 2, 2, 0, -2]         # half to even
    assert not q8[7].any() and float(mult[7]) == 0.0


@pytest.mark.parametrize("mask_from", [None, 7000])
@pytest.mark.parametrize("mode", ["bf16", "int8", "f32"])
def test_tilemax_only_plain_matches_pallas(mode, mask_from):
    X, norms, lams, Q, ql, al = _fixture(9000, 64, 16, seed=31)
    (jx, jrn), (tx, trn) = _scan_corpora(X)[mode]
    ref = np.asarray(jtmf.tilemax_only(
        jx, *_jax([norms, lams, Q, ql, al]), tile=2048, subs=tso.RESCORE_SUBS,
        interpret=True, rn=jrn, mask_from=None if mask_from is None else jnp.int32(mask_from),
    ))
    kernels.reset_launches()
    got = rsk.tilemax_only(tx, *_torch([norms, lams, Q, ql, al]), tile=2048,
                           subs=tso.RESCORE_SUBS, rn=trn, mask_from=mask_from).numpy()
    assert kernels.launch_counts()["tilemax_only"] == 0
    assert got.shape == ref.shape == (16, (9000 // 2048) * tso.RESCORE_SUBS)
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.max(np.abs(ref[fin] - got[fin])) <= 2e-6


@pytest.mark.parametrize("rows", ["f32", "int8"])
def test_slab_dots_plain_matches_pallas(rows):
    X, _, _, Q, _, _ = _fixture(6000, 128, 16, seed=12)
    ts, c = 128, 5
    sel = np.sort(np.random.default_rng(3).choice(6000 // ts, size=(16, c)), axis=1)
    if rows == "int8":
        jx = _quantize_rows_device_jit(jnp.asarray(X))[0]
        tx = torch.from_numpy(np.asarray(jx))
    else:
        jx, tx = jnp.asarray(X), torch.from_numpy(X)
    ref = np.asarray(jtmf.slab_dots_ring(jx, jnp.asarray(Q), jnp.asarray(sel, jnp.int32), ts,
                                         interpret=True))
    got = rsk.slab_dots(tx, torch.from_numpy(Q), torch.from_numpy(sel).long(), ts).numpy()
    assert got.shape == ref.shape == (16, c, ts)
    xn = np.linalg.norm(np.asarray(tx, np.float64), axis=1)
    rows_of = sel[:, :, None] * ts + np.arange(ts)
    scale = np.linalg.norm(Q, axis=1)[:, None, None] * xn[rows_of]
    assert np.all(np.abs(ref - got) <= 1e-5 * np.maximum(scale, 1e-30))


@pytest.mark.parametrize("f", [64, 128])
@pytest.mark.parametrize("mode", ["bf16", "int8", "f32"])
def test_fused_scan_rescored_matches_reference(mode, f):
    n, b, k, cand = 9000, 16, 5, 64
    arrs = _fixture(n, f, b, seed=33 + f)
    (jx, jrn), (tx, trn) = _scan_corpora(arrs[0])[mode]
    ref_idx, ref_top = jso.fused_scan_rescored(jx, *_jax(arrs[:5]), k, cand, jnp.asarray(arrs[5]),
                                               scan_rn=jrn)
    X, norms, lams, Q, ql, al = _torch(arrs)
    idx, top = tso.fused_scan_rescored(tx, X, norms, lams, Q, ql, k, cand, al, scan_rn=trn)
    assert not same_k_mismatches(ref_idx, ref_top, idx.numpy(), top.numpy())
    exact = tso._batched_scores(X, norms, lams, Q, ql, al)
    assert torch.allclose(torch.gather(exact, 1, idx), top, atol=1e-6, rtol=0)
    # Self-queries rank themselves first.
    idx2, _ = tso.fused_scan_rescored(tx, X, norms, lams, X[10:26], lams[10:26], k, cand,
                                      torch.full((16,), 0.7))
    assert idx2[:, 0].tolist() == list(range(10, 26))


@pytest.mark.parametrize("mask_from", [8000, 8500])
def test_fused_scan_rescored_mask_matches_reference(mask_from):
    n, b, k, cand = 9000, 16, 5, 64
    arrs = _fixture(n, 64, b, seed=8)
    ref_idx, ref_top = jso.fused_scan_rescored(
        jnp.asarray(arrs[0]), *_jax(arrs[:5]), k, cand, jnp.asarray(arrs[5]),
        mask_from=jnp.int32(mask_from),
    )
    X, norms, lams, Q, ql, al = _torch(arrs)
    idx, top = tso.fused_scan_rescored(X, X, norms, lams, Q, ql, k, cand, al, mask_from=mask_from)
    assert int(idx.max()) < mask_from
    assert not same_k_mismatches(ref_idx, ref_top, idx.numpy(), top.numpy())


@pytest.fixture(scope="module", params=[40_000, 3_000], ids=["n40000-fused", "n3000-poolcut"])
def built(request):
    """A JAX-built index carried to the port as arrays (the port's own build
    is held against the reference in test_torch_slice.py)."""
    n = request.param
    X = make_energy_test_dataset(n, 128, seed=23).astype(np.float32)
    ja, jgl = (
        jbuilder.ArrowSpaceBuilder()
        .with_lambda_graph(1.0, 6).with_sparsity_check(False)
        .with_cluster_params(max_clusters=60, radius=6.0).with_seed(5)
        .with_sampling(None).build(X)
    )
    ta, tgl = convert.arrowspace_from_arrays(
        np.asarray(ja.data), np.asarray(ja.lambdas), np.asarray(jgl.matrix),
        min_lambdas=ja.min_lambdas, max_lambdas=ja.max_lambdas,
        range_lambdas=ja.range_lambdas, graph_params=vars(jgl.graph_params),
        tau_mode=(ja.taumode.mode, ja.taumode.param), device="cpu",
    )
    Q = X[np.random.default_rng(n).choice(n, 16, replace=False)]
    return n, Q, ja, jgl, ta, tgl


TIERS = [
    dict(quantized="int8"),
    dict(quantized="int8", approx=True),
    dict(quantized="int8_rescored"),
    dict(quantized="bf16_rescored", allow_low_recall=True),
    dict(quantized="bf16x3_rescored"),
    dict(quantized="auto", recall_target=0.99),
    dict(quantized="auto"),
    dict(quantized="auto", recall_target=0.8),
    dict(quantized="int8_auto"),
    dict(quantized=True),
    dict(approx=True),
]


def _tier_id(kw):
    return "-".join(f"{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("kw", TIERS, ids=_tier_id)
def test_search_batch_tier_matches_reference(built, kw):
    n, Q, ja, jgl, ta, tgl = built
    # Both packages take the maxima-first route at 40,000 rows, the
    # pool-cut fallback at 3,000.
    fused = n >= tso.FUSED_TILEMAX_MIN_N
    assert tso.fused_rescored_path(n, 128, len(Q), K, 64) == fused
    assert jso.fused_rescored_path(n, 128, len(Q), K, 64) == fused
    ref_idx, ref_sc = ja.search_batch(Q, jgl, K, alpha=0.7, **kw)
    kernels.reset_launches()
    idx, sc = ta.search_batch(Q, tgl, K, alpha=0.7, **kw)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}
    assert idx.shape == (16, K) and sc.shape == (16, K)
    assert not same_k_mismatches(ref_idx, ref_sc, idx, sc)
    for row in idx:
        assert len(set(row.tolist())) == K


def test_small_batch_pads_to_eight_for_maxima_first_tiers(built):
    n, Q, ja, jgl, ta, tgl = built
    alphas = np.array([0.4, 0.6, 0.8], np.float32)
    ref_idx, ref_sc = ja.search_batch(Q[:3], jgl, K, alpha=alphas, quantized="bf16x3_rescored")
    idx, sc = ta.search_batch(Q[:3], tgl, K, alpha=alphas, quantized="bf16x3_rescored")
    assert idx.shape == (3, K)
    assert not same_k_mismatches(ref_idx, ref_sc, idx, sc)


def test_candidates_widen_the_pool_like_reference(built):
    n, Q, ja, jgl, ta, tgl = built
    assert ta._int8_cand(K, None) == ja._int8_cand(K, None) == 64
    for cand in (7, 100, 5000, 10**6):
        assert ta._int8_cand(K, cand) == ja._int8_cand(K, cand)
    ref_idx, ref_sc = ja.search_batch(Q, jgl, K, quantized="int8_rescored", candidates=n)
    idx, sc = ta.search_batch(Q, tgl, K, quantized="int8_rescored", candidates=n)
    assert not same_k_mismatches(ref_idx, ref_sc, idx, sc)


def test_single_query_quantized_and_approx_match_reference(built):
    n, Q, ja, jgl, ta, tgl = built
    lam = ta.prepare_query_item(Q[0], tgl)
    for kw in (dict(quantized=True), dict(approx=True)):
        ref = ja.search_lambda_aware(Q[0], lam, K, **kw)
        got = ta.search_lambda_aware(Q[0], lam, K, **kw)
        assert not same_k_mismatches([[i for i, _ in ref]], [[s for _, s in ref]],
                                     [[i for i, _ in got]], [[s for _, s in got]])


def test_rescored_predicates_follow_reference_but_take_any_b_and_f():
    for shape in [(40_000, 128, 16, 10, 64), (1_000_000, 128, 256, 10, 64),
                  (40_000, 128, 16, 10, 40_000), (20_000, 128, 16, 10, 64),
                  (40_000, 128, 2048, 10, 64), (40_000, 4096, 16, 10, 64)]:
        assert tso.fused_rescored_path(*shape) == jso.fused_rescored_path(*shape), shape
    # Mosaic's b % 8 and f % 128 rules do not bind kernels D and E.
    assert tso.fused_rescored_path(40_000, 96, 12, 10, 64)
    assert not jso.fused_rescored_path(40_000, 96, 12, 10, 64)
