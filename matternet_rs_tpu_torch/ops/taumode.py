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

Queries (:func:`query_lambdas`) route apart from the build: a batch on a
card below ``KERNEL_MIN_N`` rows of at most ``MAX_QUERY_F`` features takes
the query kernel, which also folds λ with the index's min and range in the
same launch; the sparse route and kernel A stay as above, and the CPU and
wider F take the closed form. The build, ``add_items`` and the streaming λ
pass keep :func:`taumode_lambdas_auto`.
"""

from __future__ import annotations

import torch

from matternet_rs_tpu_torch.ops._mm import mm
from matternet_rs_tpu_torch.ops.csr import EllLaplacian, ell_from_dense_laplacian
from matternet_rs_tpu_torch.ops.kernels import taumode as tk
from matternet_rs_tpu_torch.ops.kernels.taumode import (  # noqa: F401  (re-exported)
    TAU_FIXED, TAU_FLOOR, TAU_MEAN, TAU_MEDIAN, TAU_PERCENTILE,
)

SPARSE_F_THRESHOLD = 2048
KERNEL_MIN_N = 32768
_ELL_ITEM_CHUNK = 512


def select_tau(values: torch.Tensor, mode: int, param: float = 0.0) -> torch.Tensor:
    """τ from value vectors ``[..., F]`` → ``[...]``. Median averages the
    two middle values for even F (as ``jnp.median`` does; ``torch.median``
    would return the lower one); Percentile takes the sorted value at
    ``floor((F-1)·clamp(p,0,1) + 0.5)``. Floored at ``TAU_FLOOR``."""
    if mode == TAU_FIXED:
        return torch.full(values.shape[:-1], tk.fixed_tau(param), dtype=values.dtype,
                          device=values.device)
    if mode == TAU_MEAN:
        return torch.clamp(torch.mean(values, dim=-1), min=TAU_FLOOR)
    if mode not in (TAU_MEDIAN, TAU_PERCENTILE):
        raise ValueError(f"unknown tau mode {mode}")
    k0, k1 = tk.tau_ranks(values.shape[-1], mode, param)
    s = torch.sort(values, dim=-1).values
    t = s[..., k0] if k0 == k1 else (s[..., k0] + s[..., k1]) * 0.5
    return torch.clamp(t, min=TAU_FLOOR)


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
                         tau_param: float = 0.0, route_n: int | None = None) -> torch.Tensor:
    """λ batch with the reference's routing: the sparse route for an
    :class:`EllLaplacian` at any F or for ``F > SPARSE_F_THRESHOLD`` (a
    dense ``L`` is extracted to ELL first — callers that come back cache
    that, see ``GraphLaplacian.ell``); kernel A for ``N >= KERNEL_MIN_N``
    and ``F <= MAX_KERNEL_F``; the closed form below. ``route_n`` routes
    ``X`` as part of a corpus of that many rows (a mesh slot's rows route
    as the whole corpus would on one card; λ is row-independent)."""
    X = X.to(torch.float32)
    n, f = X.shape
    if route_n is not None:
        n = int(route_n)
    if isinstance(L, EllLaplacian) or f > SPARSE_F_THRESHOLD:
        ell = L if isinstance(L, EllLaplacian) else ell_from_dense_laplacian(L)
        return taumode_lambdas_ell(X, ell, tau_mode, tau_param)
    if n >= KERNEL_MIN_N and f <= tk.MAX_KERNEL_F:
        tau = select_tau(X, tau_mode, float(tau_param))
        return tk.taumode_lambdas_fused(
            X.contiguous(), L.to(torch.float32).contiguous(), tau.contiguous()
        )
    return taumode_lambdas(X, L, tau_mode, tau_param)


def query_route(X: torch.Tensor, L) -> str:
    """Which route :func:`query_lambdas` takes for ``X [B, F]``: ``"ell"``
    (an :class:`EllLaplacian`, or ``F > SPARSE_F_THRESHOLD``),
    ``"kernel_a"`` (B at least ``KERNEL_MIN_N``), ``"kernel"`` (a CUDA
    tensor with ``F <= MAX_QUERY_F``), else ``"closed"``."""
    n, f = X.shape
    if isinstance(L, EllLaplacian) or f > SPARSE_F_THRESHOLD:
        return "ell"
    if n >= KERNEL_MIN_N and f <= tk.MAX_KERNEL_F:
        return "kernel_a"
    if X.device.type == "cuda" and f <= tk.MAX_QUERY_F:
        return "kernel"
    return "closed"


def query_lambdas(X: torch.Tensor, L, tau_mode: int, tau_param: float, mn: float,
                  rng: float) -> tuple[torch.Tensor, torch.Tensor, str]:
    """Query λ: raw ``[B]``, normalised ``clamp((raw − mn) / rng, 0, 1)``
    with the index's ``mn`` and ``rng`` as host floats, and the
    :func:`query_route` taken. On ``"kernel"`` both λ come from one launch;
    the other routes compute raw as :func:`taumode_lambdas_auto` does and
    fold it with :func:`~matternet_rs_tpu_torch.ops.kernels.taumode.fold_lambdas`."""
    X = X.to(torch.float32)
    route = query_route(X, L)
    if route == "kernel":
        raw, q_lams = tk.taumode_query_lambdas(X.contiguous(), L.to(torch.float32).contiguous(),
                                               tau_mode, float(tau_param), mn, rng)
        return raw, q_lams, route
    raw = taumode_lambdas_auto(X, L, tau_mode, tau_param)
    return raw, tk.fold_lambdas(raw, mn, rng), route


def rayleigh_quotient(L: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``max(xᵀLx / xᵀx, 0)`` (0 for a zero vector), full f32."""
    num = torch.dot(x, mm(L, x))
    den = torch.dot(x, x)
    r = torch.where(den > 1e-12, num / torch.clamp(den, min=1e-12), torch.zeros_like(den))
    return torch.clamp(r, min=0.0)


def item_dispersion(x: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """The dispersion G of one vector, edge by edge (not the closed form):
    ``Σ share²`` of each edge's energy ``a_ij (x_i − x_j)²`` over the
    total, ``A = max(−L, 0)`` off the diagonal; clamped to [0, 1]."""
    A = torch.clamp(-L, min=0.0)
    A = A - torch.diag(torch.diag(A))
    diff = x[:, None] - x[None, :]
    e = A * diff * diff
    total = torch.sum(e)
    share = torch.where(total > 1e-12, e / torch.clamp(total, min=1e-12), torch.zeros_like(e))
    return torch.clamp(torch.sum(share * share), 0.0, 1.0)
