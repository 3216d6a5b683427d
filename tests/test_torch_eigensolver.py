"""Port vs reference: the LOBPCG eigensolver on the dense and the ELL
operator, ``spectral_embedding`` and ``eigsh_dense``.

The iterates are not bit-comparable (QR and ``eigh`` fix no signs, and the
rank cut may fall differently between LAPACK and XLA), so eigenvalues and
residuals are held, not vectors: eigenvalues within 1e-4 of the
reference's for the same injected start block, within 1e-3 of
``np.linalg.eigvalsh`` in f64 (the bound of ``tests/test_large_f.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu.ops import csr as jcsr
from matternet_rs_tpu.ops import eigensolver as jeig

from matternet_rs_tpu_torch.ops import csr as tcsr
from matternet_rs_tpu_torch.ops import eigensolver as teig
from matternet_rs_tpu_torch.ops import kernels


def _topk_laplacian(f, k, seed=0):
    """The Laplacian of ``tests/test_large_f.py``."""
    rng = np.random.default_rng(seed)
    W = np.zeros((f, f), np.float32)
    for i in range(f):
        nbrs = rng.choice(f - 1, k, replace=False)
        nbrs[nbrs >= i] += 1
        W[i, nbrs] = rng.random(k).astype(np.float32)
    W = np.maximum(W, W.T)
    return np.diag(W.sum(1)).astype(np.float32) - W


@pytest.fixture(scope="module")
def problem():
    L = _topk_laplacian(256, 6, seed=11)
    X0 = np.random.default_rng(12).normal(size=(256, 6)).astype(np.float32)
    true = np.linalg.eigvalsh(L.astype(np.float64))[:6]
    return L, X0, true


@pytest.mark.parametrize("operator", ["dense", "ell"])
def test_lobpcg_matches_reference_for_the_same_start_block(problem, operator):
    L, X0, true = problem
    if operator == "dense":
        jA, tA = jnp.asarray(L), torch.from_numpy(L)
    else:
        jA = jcsr.ell_from_dense_laplacian(jnp.asarray(L))
        tA = tcsr.ell_from_dense_laplacian(torch.from_numpy(L))
    ref_vals, _ = jeig.lobpcg_smallest(jA, 6, iters=80, X0=jnp.asarray(X0))
    kernels.reset_launches()
    vals, vecs = teig.lobpcg_smallest(tA, 6, iters=80, X0=X0)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}
    assert isinstance(vals, np.ndarray) and vals.shape == (6,) and vecs.shape == (256, 6)
    assert np.allclose(vals, ref_vals, atol=1e-4)
    assert np.allclose(vals, true, atol=1e-3)
    assert np.all(np.diff(vals) >= -1e-6)
    resid = np.linalg.norm(L @ vecs - vecs * vals[None, :], axis=0)
    assert resid.max() <= 1e-2
    assert np.allclose(vecs.T @ vecs, np.eye(6), atol=1e-3)


def test_lobpcg_ell_equals_dense_operator_and_accepts_arrays(problem):
    L, X0, true = problem
    v_d, _ = teig.lobpcg_smallest(L, 6, iters=80, X0=X0, device="cpu")      # a numpy matrix
    v_e, _ = teig.lobpcg_smallest(tcsr.ell_from_dense_laplacian(torch.from_numpy(L)), 6,
                                  iters=80, X0=torch.from_numpy(X0))
    assert np.allclose(v_d, v_e, atol=1e-4)
    assert np.allclose(v_e, true, atol=1e-3)


def test_lobpcg_default_start_is_deterministic_per_seed(problem):
    L, _, true = problem
    Lt = torch.from_numpy(L)
    a, va = teig.lobpcg_smallest(Lt, 4, iters=60, seed=3)
    b, vb = teig.lobpcg_smallest(Lt, 4, iters=60, seed=3)
    c, _ = teig.lobpcg_smallest(Lt, 4, iters=60, seed=4)
    assert np.array_equal(a, b) and np.array_equal(va, vb)
    assert np.allclose(a, true[:4], atol=1e-3) and np.allclose(c, true[:4], atol=1e-3)
    few, vecs = teig.lobpcg_smallest(torch.from_numpy(L[:3, :3].copy()), 5, iters=5)
    assert few.shape == (3,) and vecs.shape == (3, 3)                      # k clamps to n


@pytest.mark.parametrize("seed", [0, 3, 2**32 + 5])
def test_lobpcg_default_start_is_the_reference_draw(problem, monkeypatch, seed):
    """Without ``X0`` both packages start from ``normal(PRNGKey(seed), (n,
    k))``: the port's block is the reference's within 4 ulp
    (``tests/test_torch_prng.py``), and the eigenvalues agree."""
    import jax

    L, _, true = problem
    seen = []
    core = teig._lobpcg_core
    monkeypatch.setattr(teig, "_lobpcg_core", lambda mv, X0, k, it: seen.append(X0) or core(mv, X0, k, it))
    vals, _ = teig.lobpcg_smallest(torch.from_numpy(L), 4, iters=60, seed=seed)
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (L.shape[0], 4), jnp.float32))
    got = seen[0].numpy()
    gap = np.abs(ref.view(np.int32).astype(np.int64) - got.view(np.int32).astype(np.int64))
    assert got.shape == ref.shape and gap.max() <= 4
    ref_vals, _ = jeig.lobpcg_smallest(jnp.asarray(L), 4, iters=60, seed=seed)
    assert np.allclose(vals, ref_vals, atol=1e-4) and np.allclose(vals, true[:4], atol=1e-3)


def test_lobpcg_on_the_direct_ell_build_with_minus_one_slots():
    """An ELL graph from the direct build (empty slots at −1) as operator,
    in both its unnormalised and its ``L_sym`` form (diagonal 1)."""
    from matternet_rs_tpu_torch.graph import GraphParams
    from matternet_rs_tpu_torch.ops import laplacian as tlap

    nodes = torch.from_numpy(np.random.default_rng(13).normal(size=(200, 20)).astype(np.float32))
    p = GraphParams(eps=1.0, k=6, topk=5, sparsity_check=False)
    for normalized in (False, True):
        gl = tlap.build_laplacian_ell(nodes, p, normalized=normalized, row_tile=64)
        assert int((gl.ell().indices < 0).sum()) > 0
        vals, _ = teig.lobpcg_smallest(gl.ell(), 5, iters=80)
        true = np.linalg.eigvalsh(gl.dense().double().numpy())[:5]
        assert np.allclose(vals, true, atol=1e-3)


def test_spectral_embedding_separates_two_components():
    rng = np.random.default_rng(14)
    W = np.zeros((60, 60), np.float32)
    for lo, hi in ((0, 30), (30, 60)):
        B = rng.random((30, 30)).astype(np.float32) * (rng.random((30, 30)) < 0.3)
        W[lo:hi, lo:hi] = np.maximum(B, B.T)
    np.fill_diagonal(W, 0.0)
    L = np.diag(W.sum(1)) - W
    for A in (torch.from_numpy(L), tcsr.ell_from_dense_laplacian(torch.from_numpy(L))):
        emb = teig.spectral_embedding(A, 1, skip_trivial=False, iters=80)
        assert emb.shape == (60, 1)
        # The null space is spanned by the two component indicators: two
        # eigenvectors of it tell the components apart.
        two = teig.spectral_embedding(A, 2, skip_trivial=False, iters=80)
        side = two @ np.linalg.lstsq(two, np.r_[np.ones(30), -np.ones(30)], rcond=None)[0]
        assert np.all(side[:30] > 0) and np.all(side[30:] < 0)
    ref = jeig.spectral_embedding(jnp.asarray(L), 2, skip_trivial=True, iters=80)
    got = teig.spectral_embedding(torch.from_numpy(L), 2, skip_trivial=True, iters=80)
    assert got.shape == np.asarray(ref).shape == (60, 2)


def test_eigsh_dense_matches_reference(problem):
    L, _, true = problem
    ref_vals, ref_vecs = jeig.eigsh_dense(L, 6)
    vals, vecs = teig.eigsh_dense(torch.from_numpy(L), 6)
    assert np.allclose(vals, ref_vals, atol=1e-12) and np.allclose(vals, true, atol=1e-12)
    assert vecs.shape == ref_vecs.shape == (256, 6)
    assert teig.eigsh_dense(L)[0].shape == (256,)
