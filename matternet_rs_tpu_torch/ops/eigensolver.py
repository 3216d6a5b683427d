"""Blocked LOBPCG eigensolver and spectral embeddings (twin of the
reference's ``ops/eigensolver.py``).

Standard LOBPCG with Rayleigh–Ritz over the ``[X, R, P]`` subspace and a
fixed iteration count (a Python loop where the reference scans under
``jit``). The operator is a dense ``[n, n]`` product or, for an
:class:`~matternet_rs_tpu_torch.ops.csr.EllLaplacian`, the fixed-degree
sparse product ``diag∘V − W@V`` on the skinny block ``V [n, 3k]`` — kernel
F on the card, ``iters + 1`` launches per solve. The small dense products
are full-f32 ``mm``; ``torch.linalg.qr`` and ``torch.linalg.eigh`` stand
for the reference's ``jnp.linalg`` calls (on the card each is a cuSOLVER
call with host work, and stays there).

The iterates are not bit-comparable across LAPACK, XLA and cuSOLVER (QR
and ``eigh`` fix no signs, and the ``w > 1e-6`` rank cut may fall
differently); converged eigenvalues and residuals are.
"""

from __future__ import annotations

import numpy as np
import torch

from matternet_rs_tpu_torch.backend import resolve_device
from matternet_rs_tpu_torch.ops._mm import mm
from matternet_rs_tpu_torch.ops.csr import EllLaplacian


def _orthonormalize(V: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(V).Q


def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.T)


def _lobpcg_core(matvec, X0: torch.Tensor, k: int, iters: int):
    """Blocked LOBPCG with per-block orthogonalisation and the standard
    Ritz-restricted conjugate direction (P built from the R/P rows of the
    Ritz coefficients, not an X-projection), which converges on clustered
    spectra where the naive variant stalls."""
    X = _orthonormalize(X0)
    AX = matvec(X)
    theta = torch.sum(X * AX, dim=0)
    P = torch.zeros_like(X)
    for _ in range(iters):
        R = AX - X * theta[None, :]
        # Orthogonalise the blocks against X (and each other via QR) so the
        # Rayleigh–Ritz basis keeps block identity: S = [X | R' | P'].
        R = _orthonormalize(R - mm(X, mm(X.T, R)))
        P_ = P - mm(X, mm(X.T, P)) - mm(R, mm(R.T, P))
        # Normalise P's columns; a zero P (first iteration) stays harmless.
        p_norm = torch.sqrt(torch.sum(P_ * P_, dim=0))
        P_ = torch.where(p_norm[None, :] > 1e-8, P_ / torch.clamp(p_norm, min=1e-8),
                         torch.zeros_like(P_))

        S = torch.cat([X, R, P_], dim=1)                    # [n, 3k]
        AS = matvec(S)
        G = _sym(mm(S.T, AS))
        M = _sym(mm(S.T, S))
        # Generalised Rayleigh–Ritz without a Cholesky: M ≈ I except for the
        # (possibly degenerate) P block — eigh of M^{-1/2} G M^{-1/2}.
        w, V = torch.linalg.eigh(M)
        valid = w > 1e-6
        inv_sqrt = torch.where(valid, 1.0 / torch.sqrt(torch.clamp(w, min=1e-6)),
                               torch.zeros_like(w))
        T = V * inv_sqrt[None, :]
        Gt = _sym(mm(T.T, mm(G, T)))
        # Rank-deficient directions of S were zeroed by the soft inverse and
        # would show as spurious 0-eigenvalues; push them past the spectrum.
        big = 10.0 * (torch.sum(torch.abs(torch.diag(G))) + 1.0)
        Gt = Gt + torch.diag(torch.where(valid, torch.zeros_like(w), big))
        evals, evecs = torch.linalg.eigh(Gt)
        C = mm(T, evecs[:, :k])                             # back-transform
        X_new = mm(S, C)
        AX_new = mm(AS, C)
        theta = evals[:k]
        # Conjugate direction: the R/P contribution to the new X.
        C_rp = C.clone()
        C_rp[:k, :] = 0.0
        P = mm(S, C_rp)
        # Renormalise X's columns (guards drift from the soft inverse).
        xn = torch.clamp(torch.sqrt(torch.sum(X_new * X_new, dim=0)), min=1e-12)
        X = X_new / xn[None, :]
        AX = AX_new / xn[None, :]
    return theta, X


def _lobpcg_dense(A: torch.Tensor, X0: torch.Tensor, k: int, iters: int):
    return _lobpcg_core(lambda V: mm(A, V), X0, k, iters)


def _lobpcg_ell(ell: EllLaplacian, X0: torch.Tensor, k: int, iters: int):
    """LOBPCG with the Laplacian applied as the ELL product
    ``L@V = diag∘V − W@V`` (no dense ``[n, n]`` operand)."""
    return _lobpcg_core(ell.matvec, X0, k, iters)


def lobpcg_smallest(A, k: int, iters: int = 60, seed: int = 0, X0=None,
                    device=None) -> tuple[np.ndarray, np.ndarray]:
    """Smallest-k eigenpairs of symmetric ``A``: a dense ``[n, n]`` tensor
    or array, or an :class:`EllLaplacian`. Runs on ``A``'s device when it
    is a tensor or an ELL graph; an array goes to ``device`` (``None`` is
    the CUDA card). Returns numpy ``(eigenvalues [k] ascending,
    eigenvectors [n, k])``.

    Without ``X0`` the start block is drawn from a CPU ``torch.Generator``
    seeded with ``seed`` — not the reference's ``jax.random`` stream, so
    the two packages start alike only when given the same ``X0``."""
    if isinstance(A, EllLaplacian):
        dev = A.device
    elif isinstance(A, torch.Tensor):
        dev = A.device
    else:
        dev = resolve_device(device)
        A = torch.from_numpy(np.array(A, np.float32))
    n = A.shape[0]
    k = min(k, n)
    if X0 is None:
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        X0 = torch.randn((n, k), generator=gen, dtype=torch.float32)
    X0 = torch.as_tensor(X0, dtype=torch.float32).to(dev)
    if isinstance(A, EllLaplacian):
        theta, X = _lobpcg_ell(A, X0, k, iters)
    else:
        theta, X = _lobpcg_dense(A.to(dev, torch.float32), X0, k, iters)
    return theta.cpu().numpy(), X.cpu().numpy()


def spectral_embedding(L, k: int, skip_trivial: bool = True, iters: int = 80,
                       seed: int = 0, device=None) -> np.ndarray:
    """Eigenmap embedding: the k smallest non-trivial eigenvectors of L.
    For a connected unnormalised Laplacian the smallest eigenvector is the
    constant one; ``skip_trivial`` drops it."""
    extra = 1 if skip_trivial else 0
    _, vecs = lobpcg_smallest(L, k + extra, iters=iters, seed=seed, device=device)
    return vecs[:, extra:k + extra]


def eigsh_dense(L, k: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Exact dense reference (``np.linalg.eigh`` in f64) for validation and
    small F."""
    L = L.detach().cpu().numpy() if isinstance(L, torch.Tensor) else np.asarray(L)
    vals, vecs = np.linalg.eigh(L.astype(np.float64))
    if k is not None:
        vals, vecs = vals[:k], vecs[:, :k]
    return vals, vecs
