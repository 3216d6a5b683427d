"""State carried across: a built index, given as arrays, becomes the port's
``(ArrowSpace, GraphLaplacian)`` on a chosen device. The graph comes as its
dense matrix or, for an ELL-backed graph, as its three ELL arrays.

The arrays may come from any build of the same model — in the tests, the
JAX package's — so both packages can search one index. This module takes
numpy arrays and plain values only.
"""

from __future__ import annotations

import numpy as np
import torch

from matternet_rs_tpu_torch.backend import resolve_device
from matternet_rs_tpu_torch.core import ArrowSpace, TauMode
from matternet_rs_tpu_torch.graph import GraphLaplacian, GraphParams
from matternet_rs_tpu_torch.ops.csr import EllLaplacian


def ell_from_arrays(indices, weights, diag, device=None) -> EllLaplacian:
    """``indices [n, k]`` (any integer type; stored int32), ``weights
    [n, k]``, ``diag [n]`` → an :class:`EllLaplacian` on ``device``
    (``None`` is the CUDA card), its slots validated once."""
    dev = resolve_device(device)
    return EllLaplacian(
        indices=torch.from_numpy(np.array(indices, np.int32)).to(dev),
        weights=torch.from_numpy(np.array(weights, np.float32)).to(dev),
        diag=torch.from_numpy(np.array(diag, np.float32)).to(dev),
    ).check()


def graph_from_arrays(laplacian, *, graph_params: dict | None = None, init_data=None,
                      nnodes: int | None = None, device=None) -> GraphLaplacian:
    """``laplacian`` is the dense ``[n, n]`` matrix, or the ELL arrays
    ``(indices, weights, diag)`` of an ELL-backed graph; ``graph_params``
    the ``GraphParams`` fields. ``nnodes`` defaults to n."""
    dev = resolve_device(device)
    params = GraphParams(**(graph_params or {}))
    if isinstance(laplacian, tuple):
        ell = ell_from_arrays(*laplacian, device=dev)
        L, n = None, ell.n_nodes
    else:
        L = torch.from_numpy(np.array(laplacian, np.float32)).to(dev)
        ell, n = None, int(L.shape[0])
    if init_data is None:                 # node profiles are not needed to search
        init_data = np.zeros((n, 0), np.float32)
    return GraphLaplacian(
        matrix=L,
        init_data=torch.from_numpy(np.array(init_data, np.float32)).to(dev),
        nnodes=n if nnodes is None else int(nnodes),
        graph_params=params, _ell_cache=ell,
    )


def arrowspace_from_arrays(
    data,
    lambdas,
    laplacian,
    *,
    normalized: bool = True,
    min_lambdas: float | None = None,
    max_lambdas: float | None = None,
    range_lambdas: float | None = None,
    graph_params: dict | None = None,
    tau_mode: tuple[int, float] | TauMode = TauMode.median(),
    init_data=None,
    nnodes: int | None = None,
    device=None,
) -> tuple[ArrowSpace, GraphLaplacian]:
    """``data [N, F]``, ``lambdas [N]`` (normalised with the three stats
    given, or raw with ``normalized=False`` — then normalised here),
    ``laplacian`` the ``[F, F]`` matrix or the ELL arrays ``(indices,
    weights, diag)``, ``graph_params`` the ``GraphParams`` fields,
    ``tau_mode`` a ``TauMode`` or ``(mode, param)``. The sorted-λ index is
    rebuilt. ``device=None`` is the CUDA card."""
    dev = resolve_device(device)
    taumode = tau_mode if isinstance(tau_mode, TauMode) else TauMode(*tau_mode)
    aspace = ArrowSpace.from_items(data, taumode, device=dev)
    lam = torch.from_numpy(np.array(lambdas, np.float32)).to(dev)
    if normalized:
        if None in (min_lambdas, max_lambdas, range_lambdas):
            raise ValueError("normalised lambdas need min/max/range_lambdas")
        if lam.shape[0] != aspace.nitems:
            raise ValueError("lambda length mismatch")
        aspace.lambdas = lam
        aspace.min_lambdas = float(min_lambdas)
        aspace.max_lambdas = float(max_lambdas)
        aspace.range_lambdas = float(range_lambdas)
    else:
        aspace.update_lambdas(lam)
    aspace.build_lambdas_sorted()

    gl = graph_from_arrays(
        laplacian, graph_params=graph_params, init_data=init_data,
        nnodes=aspace.nitems if nnodes is None else nnodes, device=dev,
    )
    return aspace, gl
