"""State carried across: a built index, given as arrays, becomes the port's
``(ArrowSpace, GraphLaplacian)`` on a chosen device.

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
    ``laplacian [F, F]`` dense, ``graph_params`` the ``GraphParams``
    fields, ``tau_mode`` a ``TauMode`` or ``(mode, param)``. The sorted-λ
    index is rebuilt. ``device=None`` is the CUDA card."""
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

    L = torch.from_numpy(np.array(laplacian, np.float32)).to(dev)
    if init_data is None:                 # node profiles are not needed to search
        init_data = np.zeros((L.shape[0], 0), np.float32)
    gl = GraphLaplacian(
        matrix=L,
        init_data=torch.from_numpy(np.array(init_data, np.float32)).to(dev),
        nnodes=aspace.nitems if nnodes is None else int(nnodes),
        graph_params=GraphParams(**(graph_params or {})),
    )
    return aspace, gl
