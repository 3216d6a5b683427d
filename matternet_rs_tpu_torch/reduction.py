"""Johnson–Lindenstrauss implicit random projection (twin of the
reference's ``reduction.py``).

Only the seed is state: the ``[F, r]`` Gaussian (scaled by 1/√r) is drawn
from ``prng.normal(PRNGKey(seed), (F, r))`` on the host, the reference's
``jax.random`` stream, and uploaded once per (seed, F, r, device). Entries
agree with the reference's matrix to the ulp bound of :func:`prng.normal`,
so an index stored by either package projects alike in the other.
Projection is one full-f32 product (``ops/_mm.mm``, TF32 off).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from matternet_rs_tpu_torch import prng
from matternet_rs_tpu_torch.backend import resolve_device
from matternet_rs_tpu_torch.ops._mm import mm


def compute_jl_dimension(n_points: int, original_dim: int, epsilon: float) -> int:
    """JL target dimension: ``r ≥ 8·ln(n)/ε²`` clamped to [32, F], with a
    buffer of ×1.2–2.0 for F > 2048 by compression ratio."""
    if original_dim < 32:
        return original_dim
    log_n = math.log(max(n_points, 1))
    jl_bound = math.ceil(8.0 * log_n / (epsilon ** 2))
    if original_dim > 2048:
        compression_ratio = original_dim / max(jl_bound, 1)
        if compression_ratio < 10.0:
            buffer_factor = 1.2
        elif compression_ratio < 100.0:
            buffer_factor = 1.5
        else:
            buffer_factor = 2.0
        return int(min(max(math.ceil(jl_bound * buffer_factor), 32), original_dim))
    return int(min(max(jl_bound, 32), original_dim))


def projection_matrix_host(seed: int, original_dim: int, reduced_dim: int) -> np.ndarray:
    """The ``[F, r]`` float32 matrix on the host: the normal draw times
    ``float32(1/√r)``, as the reference scales it."""
    scale = np.float32(1.0 / math.sqrt(reduced_dim))
    return prng.normal(prng.PRNGKey(seed), (original_dim, reduced_dim)) * scale


@functools.lru_cache(maxsize=8)
def _projection_matrix(seed: int, original_dim: int, reduced_dim: int,
                       device: torch.device) -> torch.Tensor:
    return torch.from_numpy(projection_matrix_host(seed, original_dim, reduced_dim)).to(device)


@dataclasses.dataclass(frozen=True)
class ImplicitProjection:
    """Seed-only Gaussian projection ``[..., F] → [..., r]``."""

    original_dim: int
    reduced_dim: int
    seed: int = 42

    def matrix(self, device=None) -> torch.Tensor:
        """The ``[F, r]`` matrix on ``device`` (``None`` is the CUDA card),
        made once per device."""
        return _projection_matrix(int(self.seed), int(self.original_dim),
                                  int(self.reduced_dim), resolve_device(device))

    def project(self, x, device=None) -> torch.Tensor:
        """One full-f32 product on ``x``'s device (a tensor) or on
        ``device`` (an array; ``None`` is the CUDA card)."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, np.float32)).to(resolve_device(device))
        x = x.to(torch.float32)
        return mm(x, self.matrix(x.device))


def project_matrix(data, projection: ImplicitProjection, device=None) -> torch.Tensor:
    """Batch projection of ``[N, F]``."""
    return projection.project(data, device)
