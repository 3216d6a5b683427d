"""The port's scoring rules, each written once. Every search route and the
plain version of every scoring kernel compose these on operands already
broadcast; the CUDA epilogues (``csrc/``) are the hand-written copies. No
matmul here, and torch is the only import."""

from __future__ import annotations

import torch

TIE_EPS = 1e-9   # the cosine breaks energy ties below this |Δλ|, weighted by it


def guarded_cosine(dots, denom):
    """``dots/denom``, 0 where ``denom ≤ 1e-12``."""
    return torch.where(denom > 1e-12, dots / torch.clamp(denom, min=1e-12), torch.zeros_like(dots))


def norm_floor(qn):
    """``max(‖q‖, 1e-12)``: the query norm :func:`dequant_cosine` divides by."""
    return torch.clamp(qn, min=1e-12)


def dequant_cosine(dots, mult, qn_floor):
    """An int8 dot's cosine ``clamp(dots·mult/qn_floor, −1, 1)``, ``mult = scale/‖x‖``."""
    return torch.clamp(dots * mult / qn_floor, -1.0, 1.0)


def blend(cos, lambdas, query_lambdas, alphas):
    """``α·cos + (1 − α)·(1 − min(|λ − λq|, 1))``. A Python-float α stays
    one: ``1 − α`` is then rounded from the double, not in float32."""
    lam_sim = 1.0 - torch.clamp(torch.abs(lambdas - query_lambdas), max=1.0)
    return alphas * cos + (1.0 - alphas) * lam_sim


def energy_cosine(dots, denom):
    """``dots/(denom + 1e-9)``: the energy tie-break's cosine."""
    return dots / (denom + 1e-9)


def energy_score(lam_dist, cos):
    """``|Δλ|``, plus ``(1 − cos)·TIE_EPS`` where ``|Δλ| < TIE_EPS``; least first."""
    return lam_dist + torch.where(lam_dist < TIE_EPS, (1.0 - cos) * TIE_EPS, torch.zeros_like(cos))


def normalised(lams, mn, rng):
    """``clamp((λ − mn)/rng, 0, 1)``: raw λ on the index's scale."""
    return torch.clamp((lams - mn) / rng, 0.0, 1.0)


def _host_scalar(alpha) -> bool:
    return not isinstance(alpha, torch.Tensor) and (
        isinstance(alpha, (int, float)) or getattr(alpha, "ndim", None) == 0)


def alpha_vector(alpha, b: int, device) -> torch.Tensor:
    """``[b]`` float32 blend weights on ``device``: a host scalar filled
    there, a 0-d tensor expanded (no copy, no read-back), a vector or
    :func:`alpha_param`'s column zero-padded up to ``b``."""
    if _host_scalar(alpha):
        return torch.full((b,), float(alpha), dtype=torch.float32, device=device)
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    if a.ndim == 0:
        return a.expand(b).contiguous()
    a = a.reshape(-1)
    return torch.nn.functional.pad(a, (0, b - a.shape[0])) if a.shape[0] != b else a


def alpha_param(alpha, b: int, device):
    """Blend weights for the streamed scans: a host scalar stays a Python
    float (:func:`blend`), a 0-d tensor stays one, a ``[b]`` vector becomes
    ``[b, 1]``; a vector of another length raises ``ValueError``."""
    if _host_scalar(alpha):
        return float(alpha)
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    if a.ndim and a.shape[0] != b:
        raise ValueError(f"alpha vector length {a.shape[0]} != batch {b}")
    return a[:, None] if a.ndim else a
