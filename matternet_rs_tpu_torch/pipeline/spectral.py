"""Stage D: batched spectral λ, Rayleigh + Dirichlet (twin of the
reference's ``pipeline/spectral.py``).

λ_i = clamp(xᵢᵀLxᵢ / xᵢᵀxᵢ, ±1e6) + clamp(eᵢ / Σⱼ eⱼ, 0, 1), where eᵢ is
item i's edge energy over ``W = max(−L, 0)`` and the total runs over all
items. Three full-f32 ``[N, F] × [F, F]`` products (TF32 off, as the
reference's ``Precision.HIGHEST``); the reference computes them outside
any Pallas kernel, so they are plain ``torch.matmul`` here.
"""

from __future__ import annotations

import numpy as np
import torch

from matternet_rs_tpu_torch.backend import resolve_device
from matternet_rs_tpu_torch.ops._mm import mm
from matternet_rs_tpu_torch.pipeline.laplacian import LaplacianOutput


def _stage_d(L: torch.Tensor, X: torch.Tensor):
    XL = mm(X, L.T)
    x_sq = X * X
    num = torch.sum(X * XL, dim=-1)
    den = torch.sum(x_sq, dim=-1)
    rayleigh = torch.clamp(num / (den + 1e-9), -1e6, 1e6)
    W = torch.clamp(-L, min=0.0)
    deg = torch.sum(W, dim=1)
    edge_energy = deg[None, :] * x_sq - 2.0 * X * mm(X, W.T) + mm(x_sq, W.T)
    row_sums = torch.sum(torch.clamp(edge_energy, min=0.0), dim=-1)
    total = torch.sum(row_sums)
    dirichlet = torch.clamp(row_sums / (total + 1e-12), 0.0, 1.0)
    return rayleigh + dirichlet, rayleigh, dirichlet


def _operands(L, X):
    """``L`` and ``X`` as float32 tensors on the device of whichever is a
    tensor (``L``'s first; neither: the CUDA card)."""
    dev = resolve_device(next((t.device for t in (L, X) if isinstance(t, torch.Tensor)), None))

    def conv(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev, torch.float32)
        return torch.from_numpy(np.array(a, np.float32)).to(dev)
    return conv(L), conv(X)


def rayleigh_quotient_batch(L, X) -> torch.Tensor:
    """The Rayleigh terms alone."""
    return _stage_d(*_operands(L, X))[1]


def dirichlet_dispersion_batch(L, X) -> torch.Tensor:
    """The Dirichlet terms alone."""
    return _stage_d(*_operands(L, X))[2]


def compute_lambdas(L, X) -> np.ndarray:
    """All N λ on ``L``'s device; only the ``[N]`` result comes to the
    host, as float64."""
    return _stage_d(*_operands(L, X))[0].cpu().numpy().astype(np.float64)


def compute_tau_mode(laplacian: LaplacianOutput, data, n_items: int, n_features: int) -> np.ndarray:
    """Stage D from the stage-C output: ``data`` (rows, on the host or the
    device) reshaped to ``[n_items, n_features]``, on the Laplacian's
    device."""
    L, X = _operands(laplacian.matrix, data)
    return compute_lambdas(L, X.reshape(n_items, n_features))
