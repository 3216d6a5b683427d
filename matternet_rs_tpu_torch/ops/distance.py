"""Distance helpers for the graph build (twin of the reference's
``ops/distance.py`` functions the dense Laplacian needs)."""

from __future__ import annotations

import torch

from matternet_rs_tpu_torch.ops._mm import mm

EPS_NORM = 1e-12


def l2_norms(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """L2-normalise rows; zero rows stay zero."""
    return x / torch.clamp(l2_norms(x, keepdim=True), min=EPS_NORM)


def standardize_columns(x: torch.Tensor) -> torch.Tensor:
    """Z-score each column (population std, floored for constant columns)."""
    mean = torch.mean(x, dim=0, keepdim=True)
    std = torch.std(x, dim=0, keepdim=True, unbiased=False)
    return (x - mean) / torch.clamp(std, min=EPS_NORM)


def pairwise_cosine(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    if b is None:
        b = a
    return mm(normalize_rows(a), normalize_rows(b).T)


def rectified_cosine_distance(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``d = 1 - max(0, cos)`` ∈ [0, 1]."""
    return 1.0 - torch.clamp(pairwise_cosine(a, b), min=0.0)
