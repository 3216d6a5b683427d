"""Kernel F: the ELL sparse product (``csrc/spmv_ell.cu``).

Replaces the TPU kernels ``spmv_ell.spmv_ell_pallas`` and
``laplacian_spmv_ell_pallas``: ``W @ X`` for a graph in ELL form
(``indices/weights [n, k]``, weight 0 marks an empty slot) and a skinny
right-hand side, or ``d∘X − W@X`` with an explicit diagonal ``d``. The
plain version beside it accumulates slot by slot, in the same order.

Empty slots may carry any index (the direct graph build writes −1): a slot
with ``w == 0`` contributes nothing and its index is never used. A slot
with ``w != 0`` must name a row in ``[0, n)``; :func:`check_ell` verifies
that on the host, and the callers run it once per graph.
"""

from __future__ import annotations

import torch

from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops.kernels import _cuda


def check_ell(indices: torch.Tensor, weights: torch.Tensor) -> None:
    """Raise unless ``indices`` is int32, shaped like ``weights``, and every
    slot with a non-zero weight names a row in ``[0, n)``. Reads one scalar
    back from the device."""
    if indices.dtype != torch.int32:
        raise ValueError(f"ELL indices must be int32, got {indices.dtype}")
    if indices.ndim != 2 or indices.shape != weights.shape:
        raise ValueError(
            f"ELL indices {tuple(indices.shape)} and weights {tuple(weights.shape)} "
            "must share one [n, k] shape"
        )
    n = indices.shape[0]
    bad = (weights != 0) & ((indices < 0) | (indices >= n))
    n_bad = int(bad.sum())
    if n_bad:
        raise ValueError(
            f"{n_bad} ELL slots with a non-zero weight name a row outside [0, {n})"
        )


def spmv_ell_plain(indices, weights, X, d=None):
    """Slot-by-slot accumulation in ascending slot order; slots with
    ``w == 0`` are masked out of the sum and never index ``X``."""
    acc = torch.zeros_like(X)
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    for s in range(indices.shape[1]):
        w = weights[:, s]
        live = w != 0
        rows = X[torch.where(live, indices[:, s], 0).long()]
        acc = acc + torch.where(live[:, None], w[:, None] * rows, zero)
    return acc if d is None else d[:, None] * X - acc


def spmv_ell(indices, weights, X, d=None, *, checked: bool = False):
    """``W @ X`` (``d is None``) or ``d∘X − W@X`` → ``[n, m]`` float32.

    ``indices [n, k]`` int32, ``weights [n, k]``, ``X [n, m]``, ``d [n]``.
    ``checked=True`` says :func:`check_ell` already passed for this graph;
    otherwise it runs here. CPU tensors take the plain version; CUDA
    tensors launch kernel F."""
    if not checked:
        check_ell(indices, weights)
    n, k = indices.shape
    if X.ndim != 2 or X.shape[0] != n or (d is not None and d.shape != (n,)):
        raise ValueError(
            f"spmv_ell: indices {tuple(indices.shape)}, X {tuple(X.shape)}"
            + ("" if d is None else f", d {tuple(d.shape)}")
        )
    if X.device.type == "cpu":
        return spmv_ell_plain(indices, weights, X, d)
    lib = _cuda.library("spmv_ell")
    tensors = dict(weights=weights, X=X) if d is None else dict(weights=weights, X=X, d=d)
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"spmv_ell kernel: {name} must be float32, got {t.dtype}")
    dev = _cuda.require_cuda("spmv_ell kernel", indices=indices, **tensors)
    m = X.shape[1]
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    if n == 0 or m == 0:
        return out
    if k == 0:
        return out.zero_() if d is None else d[:, None] * X
    rc = lib.mrs_spmv_ell(
        indices.data_ptr(), weights.data_ptr(), X.data_ptr(),
        None if d is None else d.data_ptr(), out.data_ptr(), n, k, m,
        _cuda.stream_ptr(dev),
    )
    _cuda.check(lib, rc, "spmv_ell kernel")
    kernels.LAUNCHES["spmv_ell"] += 1
    return out
