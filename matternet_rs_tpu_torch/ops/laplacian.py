"""Cosine-kernel kNN graph Laplacian, dense path (twin of the reference's
``ops/laplacian.py`` dense build).

Steps, as in the reference: optional column standardisation, rectified
cosine kNN with self excluded, kernel weights ``1/(1+(d/σ)^p)``, inline
degree sparsification when the mean degree exceeds 10, union
symmetrisation ``W = max(W, Wᵀ)``, then ``L = D - W`` (or ``L_sym``).

Tie order: the reference's ``lax.top_k`` and ``jnp.argsort`` break ties
lowest index first; here both are a stable ``torch.sort``
(:func:`~matternet_rs_tpu_torch.ops.search.topk_stable`).
"""

from __future__ import annotations

import torch

from matternet_rs_tpu_torch.graph import ELL_NOT_PORTED, GraphLaplacian, GraphParams
from matternet_rs_tpu_torch.ops import distance as dist_ops
from matternet_rs_tpu_torch.ops.search import topk_stable

WEIGHT_FLOOR = 1e-12
SPARSIFY_AVG_DEGREE = 10.0
DIRECT_ELL_N = 8192


def _adjacency_dense(
    nodes: torch.Tensor, eps: float, p: float, sigma: float, topk: int,
    normalise: bool,
) -> torch.Tensor:
    """Dense symmetric weighted adjacency ``W [n, n]`` from node profiles."""
    n = nodes.shape[0]
    f32 = dict(dtype=torch.float32, device=nodes.device)
    eps_t, p_t, sigma_t = (torch.tensor(v, **f32) for v in (eps, p, sigma))
    x = dist_ops.standardize_columns(nodes) if normalise else nodes

    d = dist_ops.rectified_cosine_distance(x)
    d.fill_diagonal_(float("inf"))

    kk = min(topk, n - 1)
    neg_d, idx = topk_stable(-d, kk)                # [n, kk]
    nd = -neg_d
    valid = nd <= eps_t

    w = 1.0 / (1.0 + (nd / sigma_t) ** p_t)
    vmask = valid & (w > WEIGHT_FLOOR)
    w = torch.where(vmask, w, torch.zeros_like(w))

    degrees = valid.sum(dim=1)
    sparsify = degrees.to(torch.float32).mean() > SPARSIFY_AVG_DEGREE

    deg_f = degrees.to(torch.float32)
    score = w * torch.sqrt(deg_f[:, None] * deg_f[idx])
    score = torch.where(vmask, score, torch.full_like(score, -float("inf")))
    order = torch.argsort(-score, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    n_valid = vmask.sum(dim=1)
    keep_count = torch.where(
        n_valid > 2, torch.clamp(n_valid // 2, min=1), n_valid
    )
    keep_mask = ranks < keep_count[:, None]
    w = torch.where(sparsify & ~keep_mask, torch.zeros_like(w), w)

    W = torch.zeros((n, n), **f32).scatter_reduce(
        1, idx, w, reduce="amax", include_self=True
    )
    return torch.maximum(W, W.T)


def laplacian_from_adjacency(W: torch.Tensor) -> torch.Tensor:
    """Unnormalised ``L = D - W``."""
    return torch.diag(W.sum(dim=1)) - W


def sym_normalized_laplacian(W: torch.Tensor) -> torch.Tensor:
    """``L_sym = I - D^{-1/2} W D^{-1/2}`` with isolated nodes left as I."""
    deg = W.sum(dim=1)
    inv_sqrt = torch.where(
        deg > 0, 1.0 / torch.sqrt(torch.clamp(deg, min=1e-30)), torch.zeros_like(deg)
    )
    Wn = W * inv_sqrt[:, None] * inv_sqrt[None, :]
    return torch.eye(W.shape[0], dtype=W.dtype, device=W.device) - Wn


def build_adjacency(nodes: torch.Tensor, params: GraphParams) -> torch.Tensor:
    return _adjacency_dense(
        nodes.to(torch.float32), float(params.eps), float(params.p),
        params.sigma_value(), int(params.topk), bool(params.normalise),
    )


def build_laplacian_matrix(
    nodes: torch.Tensor,
    params: GraphParams,
    n_items: int | None = None,
    energy: bool = False,
    normalized: bool = False,
) -> GraphLaplacian:
    """Laplacian over the rows of ``nodes [n, profile]``; ``normalized``
    gives ``L_sym``. Raises for ``n >= DIRECT_ELL_N`` (the ELL build)."""
    nodes = nodes.to(torch.float32)
    n = nodes.shape[0]
    if n < 2 or nodes.shape[1] < 2:
        raise ValueError(
            f"nodes should be at least of shape (2,2): {tuple(nodes.shape)}"
        )
    if n >= DIRECT_ELL_N:
        raise NotImplementedError(ELL_NOT_PORTED)
    W = build_adjacency(nodes, params)
    L = sym_normalized_laplacian(W) if normalized else laplacian_from_adjacency(W)
    gl = GraphLaplacian(
        matrix=L,
        init_data=nodes,
        nnodes=n if n_items is None else int(n_items),
        graph_params=params,
        energy=energy,
    )
    if params.sparsity_check:
        sp = gl.sparsity(tol=1e-12)
        if sp > 0.95:
            raise ValueError(f"Resulting laplacian matrix is too sparse {sp}")
    return gl


def build_laplacian_from_k_cluster(
    centroids: torch.Tensor, params: GraphParams, n_items: int
) -> GraphLaplacian:
    """Feature-space ``F×F`` Laplacian from ``[C, F]`` centroids (graph
    nodes are features with C-length profiles)."""
    centroids = centroids.to(torch.float32)
    if centroids.shape[0] > n_items:
        raise ValueError("more centroids than items")
    return build_laplacian_matrix(centroids.T.contiguous(), params, n_items=n_items)


def build_spectral_laplacian(gl: GraphLaplacian, n_items: int) -> torch.Tensor:
    """Second-order "signals" Laplacian: the Laplacian over the rows of
    ``gl``'s matrix, with the same params."""
    return build_laplacian_matrix(
        gl.dense(), gl.graph_params, n_items=n_items
    ).dense()
