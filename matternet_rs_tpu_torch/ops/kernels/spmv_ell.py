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

:func:`spmv_ell` also takes the rows form: rows ``row0 .. row0 + n − 1``
of a taller operator against ``X [nx, m]`` (a mesh slot's rows of the
sharded Laplacian applied to the whole replicated block).

:func:`spmv_ell_plan` mirrors the launch plan the C entry point chooses
(``mrs_spmv_ell_plan``); :func:`spmv_ell_plan_chosen` asks the built
library.
"""

from __future__ import annotations

import ctypes

import torch

from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops.kernels import _cuda


# Kernel F's block and the widest column run of a lane per pass, as in
# ``csrc/spmv_ell.cu``.
THREADS = 128
MAX_COLS_PER_LANE = 8


def spmv_ell_plan(n: int, k: int, m: int) -> dict:
    """What the C entry point of kernel F chooses for ``n`` rows, ``k``
    slots and ``m`` columns: the ``group`` of lanes that shares a row (the
    smallest power of two ≥ min(m, 32)), the ``cols_per_lane`` of one pass
    (1 while m ≤ 32, else the smallest power of two ≤ 8 that covers m in
    32-lane strides), the ``rows_per_block`` of 128 threads, the
    ``blocks`` and the ``passes`` over the columns. Raises ``ValueError``
    unless n, k, m ≥ 1."""
    if n < 1 or k < 1 or m < 1:
        raise ValueError(f"spmv_ell kernel takes n, k, m >= 1, got n={n}, k={k}, m={m}")
    group = 1
    while group < min(m, 32):
        group *= 2
    cpt = 1
    while group * cpt < m and cpt < MAX_COLS_PER_LANE:
        cpt *= 2
    rows = THREADS // group
    return dict(group=group, cols_per_lane=cpt, rows_per_block=rows,
                blocks=-(-n // rows), passes=-(-m // (group * cpt)))


def spmv_ell_plan_chosen(n: int, k: int, m: int) -> dict:
    """:func:`spmv_ell_plan` as the built library itself reports it."""
    lib = _cuda.library("spmv_ell")
    group, cpt, rows, passes = (ctypes.c_int() for _ in range(4))
    blocks = ctypes.c_int64()
    rc = lib.mrs_spmv_ell_plan(n, k, m, ctypes.byref(group), ctypes.byref(cpt), ctypes.byref(rows),
                               ctypes.byref(blocks), ctypes.byref(passes))
    _cuda.check(lib, rc, "spmv_ell kernel plan")
    return dict(group=group.value, cols_per_lane=cpt.value, rows_per_block=rows.value,
                blocks=blocks.value, passes=passes.value)


def check_ell(indices: torch.Tensor, weights: torch.Tensor, nx: int | None = None) -> None:
    """Raise unless ``indices`` is int32, shaped like ``weights``, and every
    slot with a non-zero weight names a row in ``[0, nx)`` (``nx`` defaults
    to the graph's own ``n``). Reads one scalar back from the device."""
    if indices.dtype != torch.int32:
        raise ValueError(f"ELL indices must be int32, got {indices.dtype}")
    if indices.ndim != 2 or indices.shape != weights.shape:
        raise ValueError(
            f"ELL indices {tuple(indices.shape)} and weights {tuple(weights.shape)} "
            "must share one [n, k] shape"
        )
    nx = indices.shape[0] if nx is None else nx
    bad = (weights != 0) & ((indices < 0) | (indices >= nx))
    n_bad = int(bad.sum())
    if n_bad:
        raise ValueError(
            f"{n_bad} ELL slots with a non-zero weight name a row outside [0, {nx})"
        )


def spmv_ell_plain(indices, weights, X, d=None, row0: int = 0):
    """Slot-by-slot accumulation in ascending slot order; slots with
    ``w == 0`` are masked out of the sum and never index ``X``. The
    diagonal term reads rows ``row0 ..`` of ``X``."""
    n = indices.shape[0]
    acc = torch.zeros((n, X.shape[1]), dtype=X.dtype, device=X.device)
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    for s in range(indices.shape[1]):
        w = weights[:, s]
        live = w != 0
        rows = X[torch.where(live, indices[:, s], 0).long()]
        acc = acc + torch.where(live[:, None], w[:, None] * rows, zero)
    return acc if d is None else d[:, None] * X[row0:row0 + n] - acc


def _spmv_ell_launch(indices, weights, X, d, out, row0: int = 0) -> None:
    """Launch kernel F into ``out [n, m]`` on arguments that
    :func:`spmv_ell` has checked (``chip_smoke.py`` times it alone)."""
    lib = _cuda.library("spmv_ell")
    n, k = indices.shape
    rc = lib.mrs_spmv_ell(
        indices.data_ptr(), weights.data_ptr(), X.data_ptr(),
        None if d is None else d.data_ptr(), out.data_ptr(), n, k, X.shape[1],
        X.shape[0], row0, _cuda.stream_ptr(out.device),
    )
    _cuda.check(lib, rc, "spmv_ell kernel")
    kernels.count("spmv_ell")


def spmv_ell(indices, weights, X, d=None, row0: int = 0, *, checked: bool = False):
    """Rows ``row0 .. row0 + n − 1`` of ``W @ X`` (``d is None``) or
    ``d∘X − W@X`` → ``[n, m]`` float32.

    ``indices [n, k]`` int32 and ``weights [n, k]`` name rows of
    ``X [nx, m]``, ``d [n]``; the square product is ``nx = n``,
    ``row0 = 0``. ``checked=True`` says :func:`check_ell` already passed
    for this graph against ``nx``; otherwise it runs here. CPU tensors take
    the plain version; CUDA tensors launch kernel F."""
    if not checked:
        check_ell(indices, weights, X.shape[0])
    n, k = indices.shape
    if X.ndim != 2 or row0 < 0 or row0 + n > X.shape[0] or (d is not None and d.shape != (n,)):
        raise ValueError(
            f"spmv_ell: indices {tuple(indices.shape)}, X {tuple(X.shape)}, row0 {row0}"
            + ("" if d is None else f", d {tuple(d.shape)}")
        )
    if X.device.type == "cpu":
        return spmv_ell_plain(indices, weights, X, d, row0)
    _cuda.library("spmv_ell")                 # without a card: raise before anything is computed
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
        return out.zero_() if d is None else d[:, None] * X[row0:row0 + n]
    _spmv_ell_launch(indices, weights, X.contiguous(), d, out, row0)
    return out
