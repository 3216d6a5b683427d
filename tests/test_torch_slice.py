"""The slice as a whole: ``ArrowSpaceBuilder.build`` + ``search_batch`` in
both packages on the same data, the index carried across with
``convert.arrowspace_from_arrays``, and the error paths.

At N = 40,000 (> 32768) the port takes the fused route and the kernel-A
λ route with their plain versions; at N = 3,000 the flat route and the
closed form. Tolerances: normalised λ and its stats ≤ 1e-5·max(1, |x|);
scores ≤ 1e-5; ids equal up to the near-tie rule
(``matternet_rs_tpu_torch.utils.parity``).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from matternet_rs_tpu import builder as jbuilder
from matternet_rs_tpu import core as jcore
from matternet_rs_tpu import eigenmaps as jem

from matternet_rs_tpu_torch import builder as tbuilder
from matternet_rs_tpu_torch import convert
from matternet_rs_tpu_torch import core as tcore
from matternet_rs_tpu_torch import eigenmaps as tem
from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops import search as search_ops
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset
from matternet_rs_tpu_torch.utils.parity import topk_mismatches

K = 10


def _configure(b, sampling):
    b = (
        b.with_lambda_graph(1.0, 6)
        .with_sparsity_check(False)
        .with_cluster_params(max_clusters=60, radius=6.0)
        .with_seed(5)
    )
    return b if sampling else b.with_sampling(None)


def _close(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return np.all(np.abs(ref - got) <= 1e-5 * np.maximum(1.0, np.abs(ref)))


@pytest.fixture(scope="module", params=[(40_000, True), (3_000, False)],
                ids=["n40000-fused", "n3000-flat"])
def built(request):
    n, sampling = request.param
    X = make_energy_test_dataset(n, 32, seed=21).astype(np.float32)
    ja, jgl = _configure(jbuilder.ArrowSpaceBuilder(), sampling).build(X)
    kernels.reset_launches()
    ta, tgl = _configure(tbuilder.ArrowSpaceBuilder(device="cpu"), sampling).build(X)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}
    Q = X[np.random.default_rng(n).choice(n, 16, replace=False)]
    return X, Q, ja, jgl, ta, tgl


def test_build_matches_reference(built):
    X, Q, ja, jgl, ta, tgl = built
    assert np.array_equal(ja.cluster_assignments, ta.cluster_assignments)
    assert np.allclose(np.asarray(jgl.matrix), tgl.matrix.numpy(), atol=1e-6)
    for s in ("min_lambdas", "max_lambdas", "range_lambdas"):
        assert _close(getattr(ja, s), getattr(ta, s)), s
    assert _close(np.asarray(ja.lambdas), ta.lambdas.numpy())


def test_search_batch_matches_reference(built):
    X, Q, ja, jgl, ta, tgl = built
    assert search_ops.fused_fast_path(*ta.data.shape, len(Q), ta.data.dtype, K) == (len(X) >= 32768)
    ref_idx, ref_sc, ref_raw = ja.search_batch(Q, jgl, K + 1, alpha=0.7, return_raw=True)
    idx, sc, raw = ta.search_batch(Q, tgl, K, alpha=0.7, return_raw=True)
    assert _close(ref_raw, raw)
    assert not topk_mismatches(ref_idx, ref_sc, idx, sc)


def test_search_batch_per_query_alpha_and_padding(built):
    X, Q, ja, jgl, ta, tgl = built
    alphas = np.linspace(0.2, 0.9, 11).astype(np.float32)      # B = 11 → pads to 16
    ref_idx, ref_sc = ja.search_batch(Q[:11], jgl, K + 1, alpha=alphas)
    idx, sc = ta.search_batch(Q[:11], tgl, K, alpha=alphas)
    assert idx.shape == (11, K)
    assert not topk_mismatches(ref_idx, ref_sc, idx, sc)


def test_single_query_search_matches_reference(built):
    X, Q, ja, jgl, ta, tgl = built
    ref = jem.search(ja, Q[0], jgl, K + 1)
    got = tem.search(ta, Q[0], tgl, K)
    assert not topk_mismatches(
        [[i for i, _ in ref]], [[s for _, s in ref]],
        [[i for i, _ in got]], [[s for _, s in got]],
    )


def test_converted_index_searches_like_reference(built):
    """The JAX-built index, carried across as arrays, gives the reference's
    results through the port's search."""
    X, Q, ja, jgl, _, _ = built
    ta, tgl = convert.arrowspace_from_arrays(
        np.asarray(ja.data), np.asarray(ja.lambdas), np.asarray(jgl.matrix),
        min_lambdas=ja.min_lambdas, max_lambdas=ja.max_lambdas,
        range_lambdas=ja.range_lambdas,
        graph_params=vars(jgl.graph_params), tau_mode=(ja.taumode.mode, ja.taumode.param),
        device="cpu",
    )
    ref_idx, ref_sc = ja.search_batch(Q, jgl, K + 1)
    idx, sc = ta.search_batch(Q, tgl, K)
    assert not topk_mismatches(ref_idx, ref_sc, idx, sc)


def test_convert_from_raw_lambdas_normalises_like_reference(built):
    X, _, ja, jgl, _, _ = built
    raw = np.asarray(ja.lambdas) * ja.range_lambdas + ja.min_lambdas
    ta, _ = convert.arrowspace_from_arrays(
        X, raw, np.asarray(jgl.matrix), normalized=False, device="cpu"
    )
    assert _close(ja.min_lambdas, ta.min_lambdas)
    assert _close(ja.range_lambdas, ta.range_lambdas)
    assert _close(np.asarray(ja.lambdas), ta.lambdas.numpy())


def test_query_error_paths_match_reference(built):
    X, Q, ja, jgl, ta, tgl = built
    bad_dim = np.ones(X.shape[1] + 1, np.float32)
    nan_q = Q[0].copy()
    nan_q[2] = np.nan
    for query, err in ((bad_dim, ValueError), (nan_q, ValueError),
                       (np.zeros(X.shape[1], np.float32), jcore.UndecidableQueryError)):
        with pytest.raises(err):
            ja.prepare_query_item(query, jgl)
        terr = tcore.UndecidableQueryError if err is jcore.UndecidableQueryError else err
        with pytest.raises(terr):
            ta.prepare_query_item(query, tgl)
    with pytest.raises(ValueError, match="dimension"):
        ta.search_batch(bad_dim, tgl, K)


def test_tier_names_validate_then_unported_tiers_raise(built):
    """Tier names validate as in the reference (an unknown name and the
    ungated low-recall tier raise); every tier, and ``approx=True``, now
    runs and returns ``[B, k]`` (held against the reference in
    test_torch_rescored.py)."""
    _, Q, ja, jgl, ta, tgl = built
    for tier in ("bogus", "bf16x3"):
        with pytest.raises(ValueError, match="unknown quantized tier"):
            ta.search_batch(Q, tgl, K, quantized=tier)
    with pytest.raises(ValueError, match="allow_low_recall"):
        ta.search_batch(Q, tgl, K, quantized="bf16_rescored")
    for kw in (dict(quantized="int8"), dict(quantized="int8_rescored"),
               dict(quantized="bf16x3_rescored"), dict(quantized="auto"),
               dict(quantized="int8_auto"), dict(quantized=True),
               dict(quantized="bf16_rescored", allow_low_recall=True), dict(approx=True)):
        idx, sc = ta.search_batch(Q, tgl, K, **kw)
        assert idx.shape == sc.shape == (len(Q), K), kw
        assert np.all(np.isfinite(sc)), kw


def test_unported_builder_options_raise(tmp_path):
    """Every builder option is ported now (``tests/test_torch_optimal_k.py``,
    ``test_torch_reduction.py`` and ``test_torch_storage.py`` hold them
    against the reference). What still raises, as in the reference: the
    heuristic k without a seed, and persistence into a directory that
    cannot be made."""
    from matternet_rs_tpu_torch.storage import StorageError

    b = tbuilder.ArrowSpaceBuilder(device="cpu")
    assert b.with_dims_reduction(True, rp_eps=0.4) is b
    assert (b.use_dims_reduction, b.rp_eps) == (True, 0.4)
    X = make_energy_test_dataset(200, 8, seed=1)
    with pytest.raises(ValueError, match="clustering_seed"):
        tbuilder.ArrowSpaceBuilder(device="cpu").build(X)
    (tmp_path / "file").write_text("x")
    with pytest.raises(StorageError, match="cannot create"):
        (tbuilder.ArrowSpaceBuilder(device="cpu").with_seed(1)
         .with_persistence("x", tmp_path / "file" / "sub").build(X))


def test_search_without_lambdas_raises():
    a = tcore.ArrowSpace.from_items(np.eye(3, dtype=np.float32), device="cpu")
    with pytest.raises(RuntimeError, match="lambdas not computed"):
        a.search_batch(np.eye(3, dtype=np.float32), None, 2)


def test_taumode_names_match_reference():
    for ctor in ("median", "mean"):
        assert getattr(tcore.TauMode, ctor)().name == getattr(jcore.TauMode, ctor)().name
    assert tcore.TauMode.fixed(0.2) == tcore.TauMode(jcore.TauMode.fixed(0.2).mode, 0.2)
    assert tcore.TauMode.percentile(0.3).mode == jcore.TauMode.percentile(0.3).mode
    assert jnp.float32(tcore.TAU_FLOOR) == jnp.float32(jcore.TAU_FLOOR)
