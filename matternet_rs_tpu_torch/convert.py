"""State carried across: a built index, given as arrays, becomes the port's
``(ArrowSpace, GraphLaplacian)`` on a chosen device; a mesh index's padded
arrays become a ``ShardedArrowSpace`` on a mesh, and a sharded sketch's
buffers a ``ShardedSketch``. The graph comes as its dense matrix or, for
an ELL-backed graph, as its three ELL arrays.

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
from matternet_rs_tpu_torch.reduction import ImplicitProjection


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
    projection: tuple[int, int, int] | None = None,
    sub_centroids=None,
    subcentroid_lambdas=None,
    centroid_map=None,
    item_norms=None,
    device=None,
) -> tuple[ArrowSpace, GraphLaplacian]:
    """``data [N, F]``, ``lambdas [N]`` (normalised with the three stats
    given, or raw with ``normalized=False`` — then normalised here),
    ``laplacian`` the ``[F, F]`` (or, with a projection, ``[r, r]``) matrix
    or the ELL arrays ``(indices, weights, diag)``, ``graph_params`` the
    ``GraphParams`` fields, ``tau_mode`` a ``TauMode`` or ``(mode,
    param)``, ``projection`` the JL projection as ``(original_dim,
    reduced_dim, seed)``. An energy index also gives ``sub_centroids [S,
    F']``, ``subcentroid_lambdas [S]``, ``centroid_map [N]`` and, if it has
    them, ``item_norms [N]`` (else ``‖x‖`` of each row); its graph is
    then marked ``energy``. The sorted-λ index is rebuilt. ``device=None`` is the CUDA card."""
    dev = resolve_device(device)
    taumode = tau_mode if isinstance(tau_mode, TauMode) else TauMode(*tau_mode)
    aspace = ArrowSpace.from_items(data, taumode, device=dev)
    if projection is not None:
        aspace.projection = ImplicitProjection(*(int(v) for v in projection))
        aspace.reduced_dim = aspace.projection.reduced_dim
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
    if sub_centroids is not None:
        aspace.sub_centroids = torch.from_numpy(np.array(sub_centroids, np.float32)).to(dev)
        aspace.subcentroid_lambdas = np.array(subcentroid_lambdas)
        aspace.centroid_map = np.array(centroid_map, np.int64)
        aspace.item_norms = (
            torch.sqrt(torch.sum(aspace.data * aspace.data, dim=1)) if item_norms is None
            else torch.from_numpy(np.array(item_norms, np.float32)).to(dev))

    gl = graph_from_arrays(
        laplacian, graph_params=graph_params, init_data=init_data,
        nnodes=aspace.nitems if nnodes is None else nnodes, device=dev,
    )
    gl.energy = sub_centroids is not None
    return aspace, gl


def sharded_arrowspace_from_arrays(mesh, X, norms, lambdas, laplacian, *, n_items: int,
                                   min_lambdas: float, range_lambdas: float,
                                   mesh_shape: tuple | None = None,
                                   graph_params: dict | None = None,
                                   tau_mode: tuple[int, float] | TauMode = TauMode.median(),
                                   projection: tuple[int, int, int] | None = None,
                                   sub_centroids=None, subcentroid_lambdas=None):
    """A mesh index, given as arrays, as the port's
    :class:`..parallel.index.ShardedArrowSpace` on ``mesh``: ``X [N_pad,
    F]``, ``norms`` and normalised ``lambdas [N_pad]`` are the whole padded
    arrays (a sharded index's shards fetched and laid end to end in row
    order), ``laplacian`` the graph as for :func:`graph_from_arrays`, the
    λ stats as the index has them. ``mesh_shape``, when given, must be the
    mesh's (the padding follows the slot count)."""
    from matternet_rs_tpu_torch.parallel.index import ShardedArrowSpace
    from matternet_rs_tpu_torch.parallel.mesh import shard_items

    if mesh_shape is not None and tuple(mesh_shape) != tuple(mesh.devices.shape):
        raise ValueError(f"mesh shape {tuple(mesh.devices.shape)} is not {tuple(mesh_shape)}")
    X = np.array(X, np.float32)
    if X.shape[0] % mesh.size:
        raise ValueError(f"{X.shape[0]} rows do not split over {mesh.size} slots")
    taumode = tau_mode if isinstance(tau_mode, TauMode) else TauMode(*tau_mode)
    lead = mesh.lead
    gl = graph_from_arrays(laplacian, graph_params=graph_params, nnodes=n_items, device=lead)
    return ShardedArrowSpace(
        mesh=mesh, X=shard_items(mesh, X), norms=shard_items(mesh, np.array(norms, np.float32)),
        lambdas=shard_items(mesh, np.array(lambdas, np.float32)), gl=gl, n_items=int(n_items),
        taumode=taumode, min_lambdas=float(min_lambdas), range_lambdas=float(range_lambdas),
        projection=None if projection is None else ImplicitProjection(*(int(v) for v in projection)),
        sub_centroids=None if sub_centroids is None
        else torch.from_numpy(np.array(sub_centroids, np.float32)).to(lead),
        subcentroid_lambdas=None if subcentroid_lambdas is None else np.array(subcentroid_lambdas),
    )


def sharded_sketch_from_arrays(index, mesh, X8, mult, lambdas_normalized, valid,
                               sketch_maxfirst: bool | None = None):
    """A sharded sketch's stacked buffers (``X8 [nb_pad, blk, F]`` int8,
    ``mult`` and normalised λ ``[nb_pad, blk]``, ``valid [nb_pad]``) as the
    port's :class:`..parallel.sketch.ShardedSketch` over ``index`` (a
    :class:`..index.streaming.StreamingIndex` of the same store) on
    ``mesh``."""
    from matternet_rs_tpu_torch.parallel.sketch import ShardedSketch

    sk = ShardedSketch.__new__(ShardedSketch)
    sk._place(index, mesh, np.array(X8, np.int8), np.array(mult, np.float32),
              np.array(lambdas_normalized, np.float32), np.array(valid, np.int32),
              sketch_maxfirst)
    return sk
