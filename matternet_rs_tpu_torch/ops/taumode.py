"""Taumode synthetic-λ engine (twin of the reference's ``ops/taumode.py``).

For each row ``x`` against the F×F feature graph ``L``: τ from the row's
own values (Fixed/Median/Mean/Percentile, floor 1e-10), the bounded
Rayleigh energy ``E/(E+τ)`` and the edge dispersion ``G`` in closed form,
``λ = τ·E/(E+τ) + (1-τ)·G``; zero rows score 0. See
:func:`~matternet_rs_tpu_torch.ops.kernels.taumode.taumode_lambdas_plain`.

Routing (:func:`taumode_lambdas_auto`): from ``KERNEL_MIN_N`` rows kernel A
(on the CPU its plain version — the same route); below it the closed form.
The reference's CHUNK_N chunking was a TPU compile artefact: λ is
row-independent, so one launch covers all N. Beyond
``SPARSE_F_THRESHOLD`` features, or for a graph given as an
:class:`~matternet_rs_tpu_torch.ops.csr.EllLaplacian`, λ takes the sparse
edge-wise route (:func:`taumode_lambdas_ell`): O(N·F·k) traffic and no
F×F operand. That route is plain PyTorch, as the reference runs it in XLA.
"""

from __future__ import annotations

import math

import torch

from matternet_rs_tpu_torch.ops.csr import EllLaplacian, ell_from_dense_laplacian
from matternet_rs_tpu_torch.ops.kernels import taumode as tk

TAU_FLOOR = tk.TAU_FLOOR

TAU_FIXED = 0
TAU_MEDIAN = 1
TAU_MEAN = 2
TAU_PERCENTILE = 3

SPARSE_F_THRESHOLD = 2048
KERNEL_MIN_N = 32768
_ELL_ITEM_CHUNK = 512


def select_tau(values: torch.Tensor, mode: int, param: float = 0.0) -> torch.Tensor:
    """τ from value vectors ``[..., F]`` → ``[...]``. Median averages the
    two middle values for even F (as ``jnp.median`` does; ``torch.median``
    would return the lower one); Percentile takes the sorted value at
    ``floor((F-1)·clamp(p,0,1) + 0.5)``. Floored at ``TAU_FLOOR``."""
    if mode == TAU_FIXED:
        t = param if (param > 0.0 and math.isfinite(param)) else TAU_FLOOR
        return torch.full(values.shape[:-1], t, dtype=values.dtype, device=values.device)
    if mode == TAU_MEAN:
        return torch.clamp(torch.mean(values, dim=-1), min=TAU_FLOOR)
    f = values.shape[-1]
    s = torch.sort(values, dim=-1).values
    if mode == TAU_MEDIAN:
        mid = f // 2
        med = s[..., mid] if f % 2 else (s[..., mid - 1] + s[..., mid]) * 0.5
        return torch.clamp(med, min=TAU_FLOOR)
    if mode == TAU_PERCENTILE:
        pp = min(max(param, 0.0), 1.0)
        idx = int(math.floor((f - 1) * pp + 0.5))
        return torch.clamp(s[..., idx], min=TAU_FLOOR)
    raise ValueError(f"unknown tau mode {mode}")


def taumode_lambdas(X: torch.Tensor, L: torch.Tensor, tau_mode: int = TAU_MEDIAN,
                    tau_param: float = 0.0) -> torch.Tensor:
    """Raw λ ``[N]`` in closed form (seven full-f32 products)."""
    X = X.to(torch.float32)
    return tk.taumode_lambdas_plain(X, L, select_tau(X, tau_mode, float(tau_param)))


def synthetic_lambda(x: torch.Tensor, L, tau_mode: int = TAU_MEDIAN,
                     tau_param: float = 0.0) -> torch.Tensor:
    """Single-vector λ (query path); scalar tensor. ``L`` is a dense matrix
    or an :class:`EllLaplacian`."""
    if isinstance(L, EllLaplacian):
        return taumode_lambdas_ell(x[None, :], L, tau_mode, tau_param, item_chunk=8)[0]
    return taumode_lambdas(x[None, :], L, tau_mode, tau_param)[0]


def _taumode_chunk_ell(Xc: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor,
                       diag: torch.Tensor, tau_mode: int, tau_param: float) -> torch.Tensor:
    """Sparse λ for one item chunk ``Xc [B, F]``, edge-wise: scan the k
    neighbour slots of the F-node graph (``indices`` int64 ``[F, k]`` with
    empty slots clamped into range, ``weights [F, k]``) and evaluate each
    directed edge ``(f, j = idx[f, s])`` directly,

        total_b += Σ_f w_fs (x_bj − x_bf)²          (Dirichlet energy)
        num4_b  += Σ_f w²_fs (x_bj − x_bf)⁴         (dispersion numerator)
        r_b     += Σ_f w_fs  x_bf · x_bj            (Rayleigh cross term)

    Per slot: one ``[F, B]`` row gather of Xᵀ, fused elementwise work and
    three per-item sums; the Rayleigh term closes with
    ``xᵀLx = Σ diag·x² − r``."""
    Xc = Xc.to(torch.float32)
    tau = select_tau(Xc, tau_mode, float(tau_param))
    Xt = Xc.T.contiguous()                       # [F, B]
    X2 = Xc * Xc
    zeros = torch.zeros(Xc.shape[0], dtype=torch.float32, device=Xc.device)
    total, num4, r = zeros, zeros, zeros
    for s in range(indices.shape[1]):
        ws = weights[:, s]
        g = Xt[indices[:, s]]                    # [F, B] row gather
        d = g - Xt
        d2 = d * d
        total = total + torch.sum(ws[:, None] * d2, dim=0)
        num4 = num4 + torch.sum((ws * ws)[:, None] * (d2 * d2), dim=0)
        r = r + torch.sum(ws[:, None] * (Xt * g), dim=0)

    num_e = torch.sum(X2 * diag[None, :], dim=-1) - r
    den = torch.sum(X2, dim=-1)
    e_raw = torch.clamp(
        torch.where(den > 1e-12, num_e / torch.clamp(den, min=1e-12), zeros), min=0.0
    )
    g_disp = torch.where(total > 1e-12, num4 / torch.clamp(total * total, min=1e-24), zeros)
    g_disp = torch.clamp(g_disp, 0.0, 1.0)
    e_bounded = torch.where(
        e_raw + tau > 0, e_raw / torch.clamp(e_raw + tau, min=TAU_FLOOR), zeros
    )
    lam = tau * e_bounded + (1.0 - tau) * g_disp
    is_zero = torch.amax(torch.abs(Xc), dim=-1) <= tk.ZERO_VEC_EPS
    return torch.where(is_zero, zeros, lam)


def taumode_lambdas_ell(X: torch.Tensor, ell: EllLaplacian, tau_mode: int = TAU_MEDIAN,
                        tau_param: float = 0.0,
                        item_chunk: int = _ELL_ITEM_CHUNK) -> torch.Tensor:
    """λ batch against an :class:`EllLaplacian`, in chunks of ``item_chunk``
    rows (the ``[F, chunk]`` gathers bound the working memory). Equal to
    :func:`taumode_lambdas` on the densified graph up to summation order.
    The reference pads the last chunk to a fixed shape for its compiler;
    λ is row-independent, so no padding is needed here."""
    X = X.to(torch.float32)
    ell.check()
    indices = ell.indices.clamp(min=0).long()
    outs = [
        _taumode_chunk_ell(X[start:start + item_chunk], indices, ell.weights, ell.diag,
                           tau_mode, float(tau_param))
        for start in range(0, X.shape[0], item_chunk)
    ]
    return torch.cat(outs) if outs else X.new_zeros(0)


def taumode_lambdas_auto(X: torch.Tensor, L, tau_mode: int = TAU_MEDIAN,
                         tau_param: float = 0.0) -> torch.Tensor:
    """λ batch with the reference's routing: the sparse route for an
    :class:`EllLaplacian` at any F or for ``F > SPARSE_F_THRESHOLD`` (a
    dense ``L`` is extracted to ELL first — callers that come back cache
    that, see ``GraphLaplacian.ell``); kernel A for ``N >= KERNEL_MIN_N``
    and ``F <= MAX_KERNEL_F``; the closed form below."""
    X = X.to(torch.float32)
    n, f = X.shape
    if isinstance(L, EllLaplacian) or f > SPARSE_F_THRESHOLD:
        ell = L if isinstance(L, EllLaplacian) else ell_from_dense_laplacian(L)
        return taumode_lambdas_ell(X, ell, tau_mode, tau_param)
    if n >= KERNEL_MIN_N and f <= tk.MAX_KERNEL_F:
        tau = select_tau(X, tau_mode, float(tau_param))
        return tk.taumode_lambdas_fused(
            X.contiguous(), L.to(torch.float32).contiguous(), tau.contiguous()
        )
    return taumode_lambdas(X, L, tau_mode, tau_param)
