"""Mesh-sharded Lloyd refinement (twin of the reference's
``parallel/clustering.py``): each slot assigns its own rows, and only the
``[C, F]`` sums and ``[C]`` counts cross the slots (``psum``) each round,
so nothing N-sized is ever gathered. Seeded from evenly spaced global rows.

The sums are reduced in another order than the reference's (per slot,
then across slots), so centroids agree to rounding and an assignment at a
near tie may flip; on data with separated clusters the two agree.
"""

from __future__ import annotations

import numpy as np
import torch

from matternet_rs_tpu_torch.ops._mm import mm
from matternet_rs_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedArray,
    local_map,
    psum,
    replicate,
    sharded,
)


def take_rows(mesh: Mesh, Xs: ShardedArray, ids) -> torch.Tensor:
    """Global rows ``ids`` of a sharded array, replicated on the lead device:
    each slot fills the rows it holds (zeros elsewhere) and one ``psum``
    adds them up (exact: one non-zero term a row)."""
    ids = np.asarray(ids, np.int64)
    per = Xs.per

    def body(slot, Xl):
        out = torch.zeros((len(ids),) + tuple(Xl.shape[1:]), dtype=Xl.dtype, device=Xl.device)
        mine = np.nonzero((ids >= slot * per) & (ids < (slot + 1) * per))[0]
        if len(mine):
            out[torch.from_numpy(mine).to(Xl.device)] = Xl[torch.from_numpy(
                ids[mine] - slot * per).to(Xl.device)]
        return out

    return psum(mesh, local_map(mesh, body, Xs))


def distributed_lloyd(mesh: Mesh, X_sharded: ShardedArray, n_items: int, k: int,
                      iters: int = 10, init_centroids=None):
    """Lloyd rounds over the sharded rows. Per round each slot assigns its
    rows (full-f32 ``‖x‖² + ‖c‖² − 2⟨x, c⟩``, first minimum), forms the
    one-hot sums (a full-f32 product) and int64 counts of its real rows
    (global id < ``n_items``); a ``psum`` reduces them; empty clusters keep
    their centroid. Returns ``(centroids [k, F] np, counts [k] np,
    assignments)``, the last a :class:`ShardedArray` of int64 with -1 on
    padded rows."""
    per = X_sharded.per
    if init_centroids is None:
        init_centroids = take_rows(mesh, X_sharded,
                                   np.linspace(0, n_items - 1, k).round().astype(np.int64))
    cents = torch.as_tensor(np.asarray(init_centroids, np.float32)
                            if not isinstance(init_centroids, torch.Tensor)
                            else init_centroids, dtype=torch.float32).to(mesh.lead)
    counts = torch.zeros(k, dtype=torch.int64, device=mesh.lead)
    assign = None

    def round_(slot, Xl, C):
        valid = (slot * per + torch.arange(per, device=Xl.device)) < n_items
        d = (torch.sum(Xl * Xl, dim=-1, keepdim=True) + torch.sum(C * C, dim=-1)[None, :]
             - 2.0 * mm(Xl, C.T))
        a = torch.argmin(d, dim=1)
        one_hot = (a[:, None] == torch.arange(C.shape[0], device=Xl.device)[None, :]) & valid[:, None]
        sums = mm(one_hot.to(Xl.dtype).T, Xl)
        cnt = torch.bincount(a[valid], minlength=C.shape[0])
        return sums, cnt, torch.where(valid, a, -1)

    for _ in range(iters):
        outs = local_map(mesh, round_, X_sharded, replicate(mesh, cents))
        sums = psum(mesh, [o[0] for o in outs])
        counts = psum(mesh, [o[1] for o in outs])
        cf = counts.to(torch.float32)
        cents = torch.where(counts[:, None] > 0, sums / torch.clamp(cf, min=1.0)[:, None], cents)
        assign = [o[2] for o in outs]
    if assign is None:
        assign = local_map(mesh, lambda slot, Xl: torch.full(
            (per,), -1, dtype=torch.int64, device=Xl.device), X_sharded)
    return (cents.cpu().numpy(), counts.cpu().numpy(),
            sharded(mesh, assign, (X_sharded.shape[0],)))
