"""Distance and similarity functions (twin of the reference's
``ops/distance.py``): row norms, cosine, squared and plain Euclidean
pairwise distances by the matmul expansion, and the diagonal-Gaussian
Bhattacharyya distance with its coefficient.

:func:`bhattacharyya_pairwise` is tiled: the reference broadcasts an
``[M, N, F]`` intermediate (40 GB at M = N = 10,000, F = 100, the staged
pipeline's default cap); here the rows of the first operand go in blocks
whose ``[blk, N, F]`` intermediates hold at most ``PAIRWISE_BLOCK_ELEMS``
elements, and the sum over F is a fixed pairwise tree, so every entry is
summed in the same order whatever the block size.
"""

from __future__ import annotations

import torch

from matternet_rs_tpu_torch.ops._mm import mm

EPS_NORM = 1e-12
VAR_FLOOR = 1e-6
# Elements of one [blk, N, F] intermediate of the tiled Bhattacharyya
# pass (256 MiB in float32).
PAIRWISE_BLOCK_ELEMS = 1 << 26


def l2_norms(x: torch.Tensor, axis: int = -1, keepdims: bool = False) -> torch.Tensor:
    """Row L2 norms (the reference's names: ``axis``, ``keepdims``)."""
    return torch.sqrt(torch.sum(x * x, dim=axis, keepdim=keepdims))


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """L2-normalise rows; zero rows stay zero."""
    return x / torch.clamp(l2_norms(x, keepdims=True), min=EPS_NORM)


def standardize_columns(x: torch.Tensor) -> torch.Tensor:
    """Z-score each column (population std, floored for constant columns)."""
    mean = torch.mean(x, dim=0, keepdim=True)
    std = torch.std(x, dim=0, keepdim=True, unbiased=False)
    return (x - mean) / torch.clamp(std, min=EPS_NORM)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine of two vectors (0 when either is ~zero)."""
    denom = torch.sqrt(torch.sum(a * a)) * torch.sqrt(torch.sum(b * b))
    return torch.where(denom > EPS_NORM, torch.dot(a, b) / torch.clamp(denom, min=EPS_NORM),
                       torch.zeros_like(denom))


def pairwise_cosine(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    if b is None:
        b = a
    return mm(normalize_rows(a), normalize_rows(b).T)


def rectified_cosine_distance(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``d = 1 - max(0, cos)`` ∈ [0, 1]."""
    return 1.0 - torch.clamp(pairwise_cosine(a, b), min=0.0)


def pairwise_sqeuclidean(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``[M, N]`` squared distances ``‖a‖² + ‖b‖² − 2⟨a, b⟩`` (full-f32
    product), clamped at 0."""
    if b is None:
        b = a
    a_sq = torch.sum(a * a, dim=-1, keepdim=True)
    b_sq = torch.sum(b * b, dim=-1, keepdim=True).T
    return torch.clamp(a_sq + b_sq - 2.0 * mm(a, b.T), min=0.0)


def pairwise_euclidean(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    return torch.sqrt(pairwise_sqeuclidean(a, b))


def bhattacharyya_diagonal(mu1, var1, mu2, var2, var_floor: float = VAR_FLOOR) -> torch.Tensor:
    """Bhattacharyya distance of diagonal Gaussians (over the last axis):
    ``1/8 Σ (μ1−μ2)²/σ̄² + 1/2 Σ ln(σ̄²/√(σ1²σ2²))``, ``σ̄² = (σ1²+σ2²)/2``,
    variances floored at ``var_floor``."""
    v1 = torch.clamp(var1, min=var_floor)
    v2 = torch.clamp(var2, min=var_floor)
    vbar = 0.5 * (v1 + v2)
    mterm = 0.125 * torch.sum((mu1 - mu2) ** 2 / vbar, dim=-1)
    vterm = 0.5 * torch.sum(torch.log(vbar / torch.sqrt(v1 * v2)), dim=-1)
    return mterm + vterm


def tree_sum_last(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed pairwise order: halves added
    elementwise until one column is left (an odd column carried to the
    next level). Each entry's order depends on the axis length only."""
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        head = t[..., :h] + t[..., h:2 * h]
        t = torch.cat([head, t[..., 2 * h:]], dim=-1) if t.shape[-1] % 2 else head
    return t[..., 0]


def bhattacharyya_pairwise(mu_a, var_a, mu_b=None, var_b=None, var_floor: float = VAR_FLOOR,
                           block_elems: int = PAIRWISE_BLOCK_ELEMS) -> torch.Tensor:
    """``[M, N]`` pairwise Bhattacharyya distances, the reference's
    per-element terms ``diff²/σ̄²`` and ``ln σ̄² − (ln σa² + ln σb²)/2``.

    Tiled: rows of ``a`` go in blocks of ``blk = block_elems // (N·F)``
    (at least one row), so an ``[blk, N, F]`` intermediate holds at most
    ``block_elems`` elements, and each entry's sum over F is
    :func:`tree_sum_last`'s, whatever the block size."""
    if mu_b is None:
        mu_b, var_b = mu_a, var_a
    m, n, f = mu_a.shape[0], mu_b.shape[0], mu_a.shape[1]
    va = torch.clamp(var_a, min=var_floor)
    vb = torch.clamp(var_b, min=var_floor)[None]
    la, lb = torch.log(va), torch.log(vb)
    out = torch.empty((m, n), dtype=mu_a.dtype, device=mu_a.device)
    blk = max(1, min(m, block_elems // max(n * f, 1)))
    for s in range(0, m, blk):
        e = min(m, s + blk)
        vbar = 0.5 * (va[s:e, None] + vb)
        diff = mu_a[s:e, None] - mu_b[None]
        mterm = tree_sum_last(diff * diff / vbar)
        del diff
        vterm = tree_sum_last(torch.log(vbar) - 0.5 * (la[s:e, None] + lb))
        out[s:e] = 0.125 * mterm + 0.5 * vterm
    return out


def bhattacharyya_coefficient(distance: torch.Tensor) -> torch.Tensor:
    """Affinity in (0, 1]: ``exp(-DB)``."""
    return torch.exp(-distance)


def bhattacharyya_affinity(mu1, var1, mu2, var2, var_floor: float = VAR_FLOOR) -> torch.Tensor:
    """``exp(-DB)`` straight from the Gaussians' parameters."""
    return torch.exp(-bhattacharyya_diagonal(mu1, var1, mu2, var2, var_floor))
