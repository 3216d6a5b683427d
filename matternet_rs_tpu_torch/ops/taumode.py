"""Taumode synthetic-λ engine (twin of the reference's ``ops/taumode.py``).

For each row ``x`` against the F×F feature graph ``L``: τ from the row's
own values (Fixed/Median/Mean/Percentile, floor 1e-10), the bounded
Rayleigh energy ``E/(E+τ)`` and the edge dispersion ``G`` in closed form,
``λ = τ·E/(E+τ) + (1-τ)·G``; zero rows score 0. See
:func:`~matternet_rs_tpu_torch.ops.kernels.taumode.taumode_lambdas_plain`.

Routing (:func:`taumode_lambdas_auto`): from ``KERNEL_MIN_N`` rows kernel A
(on the CPU its plain version — the same route); below it the closed form.
The reference's CHUNK_N chunking was a TPU compile artefact: λ is
row-independent, so one launch covers all N. The sparse ELL route for
F > ``SPARSE_F_THRESHOLD`` waits (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import math

import torch

from matternet_rs_tpu_torch.graph import ELL_NOT_PORTED
from matternet_rs_tpu_torch.ops.kernels import taumode as tk

TAU_FLOOR = tk.TAU_FLOOR

TAU_FIXED = 0
TAU_MEDIAN = 1
TAU_MEAN = 2
TAU_PERCENTILE = 3

SPARSE_F_THRESHOLD = 2048
KERNEL_MIN_N = 32768


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


def synthetic_lambda(x: torch.Tensor, L: torch.Tensor, tau_mode: int = TAU_MEDIAN,
                     tau_param: float = 0.0) -> torch.Tensor:
    """Single-vector λ (query path); scalar tensor."""
    return taumode_lambdas(x[None, :], L, tau_mode, tau_param)[0]


def taumode_lambdas_auto(X: torch.Tensor, L: torch.Tensor, tau_mode: int = TAU_MEDIAN,
                         tau_param: float = 0.0) -> torch.Tensor:
    """λ batch with the reference's routing: kernel A for
    ``N >= KERNEL_MIN_N`` and ``F <= MAX_KERNEL_F``, the closed form below."""
    X = X.to(torch.float32)
    n, f = X.shape
    if f > SPARSE_F_THRESHOLD:
        raise NotImplementedError(ELL_NOT_PORTED)
    if n >= KERNEL_MIN_N and f <= tk.MAX_KERNEL_F:
        tau = select_tau(X, tau_mode, float(tau_param))
        return tk.taumode_lambdas_fused(
            X.contiguous(), L.to(torch.float32).contiguous(), tau.contiguous()
        )
    return taumode_lambdas(X, L, tau_mode, tau_param)
