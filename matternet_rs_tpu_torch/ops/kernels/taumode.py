"""Kernel A: raw taumode λ per row (``csrc/taumode.cu``).

Replaces the TPU kernels ``taumode_fused.taumode_lambdas_pallas`` and
``taumode_lambdas_pallas_bigf``: one kernel serves F ≤ ``MAX_KERNEL_F``.
The plain version beside it is the reference's closed form with τ given.
"""

from __future__ import annotations

import torch

from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops._mm import mm
from matternet_rs_tpu_torch.ops.kernels import _cuda

TAU_FLOOR = 1e-10
ZERO_VEC_EPS = 1e-10
# Kernel limit: the block keeps 16 rows of X in shared memory
# (16·F·4 bytes) beside an 8 KB L tile, within the 227 KB a block may use.
MAX_KERNEL_F = 2048


def operator_weights(L: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``A = max(-L, 0)`` with the diagonal zeroed, and the row sums of A
    and A∘A (``deg``, ``deg2``)."""
    A = torch.clamp(-L, min=0.0)
    A = A - torch.diag(torch.diag(A))
    return A, A.sum(dim=1), (A * A).sum(dim=1)


def taumode_lambdas_plain(X: torch.Tensor, L: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Closed form: seven ``[N,F]×[F,F]`` products and the λ tail, with
    per-row ``tau [N]``. Rows with max|x| ≤ 1e-10 score 0."""
    X = X.to(torch.float32)
    L = L.to(torch.float32)
    XL = mm(X, L)
    num_e = torch.sum(X * XL, dim=-1)
    den = torch.sum(X * X, dim=-1)
    zero = torch.zeros_like(den)
    e_raw = torch.where(den > 1e-12, num_e / torch.clamp(den, min=1e-12), zero)
    e_raw = torch.clamp(e_raw, min=0.0)

    A, deg, deg2 = operator_weights(L)
    A2 = A * A
    X2 = X * X
    X3 = X2 * X
    X4 = X2 * X2
    B1 = mm(X, A)
    B2 = mm(X2, A)
    C1 = mm(X, A2)
    C2 = mm(X2, A2)
    C3 = mm(X3, A2)
    C4 = mm(X4, A2)
    total = torch.sum(X2 * deg - 2.0 * X * B1 + B2, dim=-1)
    num4 = torch.sum(
        X4 * deg2 - 4.0 * X3 * C1 + 6.0 * X2 * C2 - 4.0 * X * C3 + C4, dim=-1
    )
    g = torch.where(total > 1e-12, num4 / torch.clamp(total * total, min=1e-24), zero)
    g = torch.clamp(g, 0.0, 1.0)

    e_bounded = torch.where(
        e_raw + tau > 0, e_raw / torch.clamp(e_raw + tau, min=TAU_FLOOR), zero
    )
    lam = tau * e_bounded + (1.0 - tau) * g
    is_zero = torch.amax(torch.abs(X), dim=-1) <= ZERO_VEC_EPS
    return torch.where(is_zero, zero, lam)


def taumode_lambdas_fused(X: torch.Tensor, L: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Raw λ ``[N]`` of ``X [N,F]`` against ``L [F,F]`` with per-row τ.
    CPU tensors take the plain version; CUDA tensors launch kernel A."""
    if X.device.type == "cpu":
        return taumode_lambdas_plain(X, L, tau)
    lib = _cuda.library("taumode")
    n, f = X.shape
    if L.shape != (f, f) or tau.shape != (n,):
        raise ValueError(f"taumode kernel: X {tuple(X.shape)}, L {tuple(L.shape)}, tau {tuple(tau.shape)}")
    if f > MAX_KERNEL_F:
        raise ValueError(f"taumode kernel takes F <= {MAX_KERNEL_F}, got {f}")
    for name, t in (("X", X), ("L", L), ("tau", tau)):
        if t.dtype != torch.float32:
            raise ValueError(f"taumode kernel: {name} must be float32, got {t.dtype}")
    dev = _cuda.require_cuda("taumode kernel", X=X, L=L, tau=tau)
    _, deg, deg2 = operator_weights(L)
    lam = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return lam
    rc = lib.mrs_taumode_lambda(
        X.data_ptr(), L.data_ptr(), deg.data_ptr(), deg2.data_ptr(),
        tau.data_ptr(), lam.data_ptr(), n, f, _cuda.stream_ptr(dev),
    )
    _cuda.check(lib, rc, "taumode kernel")
    kernels.LAUNCHES["taumode"] += 1
    return lam
