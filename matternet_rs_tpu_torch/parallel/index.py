"""ShardedArrowSpace: the index over a device mesh (twin of the
reference's ``parallel/index.py``).

Items, norms and λ are sharded over the mesh's slots; the F×F graph and
the λ statistics are replicated. λ needs no communication (the graph is
replicated, τ is per row); only the λ minimum and maximum are reduced. A
search scores each slot's rows, takes the slot's top-k and merges the k·D
candidates: exact and deterministic against the single-card search.

Port contract: each slot's λ takes the single-card route of the whole
corpus (:func:`..search.sharded_taumode_lambdas` with ``route_n`` = N:
kernel A from ``KERNEL_MIN_N`` rows), so a mesh index equals the
single-card port index built from the same rows and graph.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

import numpy as np
import torch

from matternet_rs_tpu_torch.core import TAUDEFAULT, TauMode, _alpha_vector, quantize_rows
from matternet_rs_tpu_torch.graph import GraphLaplacian
from matternet_rs_tpu_torch.ops import scores as score_ops
from matternet_rs_tpu_torch.ops import search as so
from matternet_rs_tpu_torch.ops import taumode as tmo
from matternet_rs_tpu_torch.ops._mm import mm
from matternet_rs_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedArray,
    all_gather,
    local_map,
    make_mesh,
    psum,
    reduce,
    replicate,
    shard_items,
    shard_items_from_blocks,
    sharded,
)
from matternet_rs_tpu_torch.parallel.search import (
    make_multislice_search,
    make_sharded_energy_search,
    make_sharded_hybrid_search,
    make_sharded_search,
    make_sharded_search_batch,
    make_sharded_search_batch_quantized,
    sharded_taumode_lambdas,
)

SHARDED_TIERS = ("auto", "int8", "int8_auto", "int8_rescored", "bf16x3_rescored")


def _normalize_sharded_lambdas(mesh: Mesh, raw: ShardedArray, n_items: int):
    """The masked global λ minimum and maximum (rows with global id ≥
    ``n_items`` left out), the maximum folded from 0 and the range floored
    at 1e-9, then ``clip((λ − min) / range, 0, 1)`` per slot. Returns
    ``(normalised ShardedArray, min, range)``; only the two stats come to
    the host."""
    per = raw.per

    def extrema(slot, r):
        valid = (slot * per + torch.arange(per, device=r.device)) < n_items
        return (torch.min(torch.where(valid, r, float("inf"))),
                torch.max(torch.where(valid, r, -float("inf"))))

    ext = local_map(mesh, extrema, raw)
    mn = reduce(mesh, [e[0] for e in ext], "min")
    mx = torch.clamp(reduce(mesh, [e[1] for e in ext], "max"), min=0.0)
    rng = torch.clamp(mx - mn, min=1e-9)
    lam = local_map(mesh, lambda _, r, a, b: score_ops.normalised(r, a, b),
                    raw, replicate(mesh, mn), replicate(mesh, rng))
    return sharded(mesh, lam, raw.shape), float(mn), float(rng)


def _row_norms(mesh: Mesh, Xs: ShardedArray) -> ShardedArray:
    return sharded(mesh, local_map(mesh, lambda _, Xl: torch.sqrt(torch.sum(Xl * Xl, dim=-1)), Xs),
                   (Xs.shape[0],))


def _taumode_graph(gl: GraphLaplacian):
    """The graph λ is taken against: its ELL form when ELL-backed or beyond
    ``SPARSE_F_THRESHOLD`` nodes (as the single-card index serves it)."""
    if gl.is_ell_backed or gl.matrix.shape[0] > tmo.SPARSE_F_THRESHOLD:
        return gl.ell()
    return gl.matrix


def _graph_on(gl: GraphLaplacian, dev: torch.device, nnodes: int | None = None) -> GraphLaplacian:
    """``gl`` with its tensors on ``dev`` (no copy when they are there)."""
    ell = gl._ell_cache
    if ell is not None and ell.device != dev:
        ell = dataclasses.replace(ell, indices=ell.indices.to(dev), weights=ell.weights.to(dev),
                                  diag=ell.diag.to(dev))
    return GraphLaplacian(
        matrix=None if gl.matrix is None else gl.matrix.to(dev),
        init_data=gl.init_data.to(dev), nnodes=gl.nnodes if nnodes is None else nnodes,
        graph_params=gl.graph_params, energy=gl.energy, _ell_cache=ell)


def _serial_centroids(blocks, n: int, k_clusters: int, radius: float,
                      centroid_sample: int | None) -> np.ndarray:
    """The serial builder's radius-gated scan over the first
    ``centroid_sample`` rows (default: all), streamed in block order."""
    from matternet_rs_tpu_torch.clustering import incremental_clustering

    budget = n if centroid_sample is None else min(centroid_sample, n)
    if budget <= 0:
        raise ValueError(
            "centroids='serial' needs at least one sample row: "
            f"centroid_sample={centroid_sample!r} over {n} items"
        )
    parts, got = [], 0
    for b in blocks:
        if got >= budget:
            break
        take = np.asarray(b, np.float32)[: budget - got]
        parts.append(np.array(take, np.float32))
        got += len(take)
    sample = parts[0] if len(parts) == 1 else np.concatenate(parts)
    return incremental_clustering(sample, max_clusters=k_clusters, radius=radius).centroids


def build_from_rows(mesh: Mesh, Xs: ShardedArray, n: int, graph_params, k_clusters: int,
                    taumode: TauMode, lloyd_iters: int, centroids: str, radius: float,
                    centroid_sample: int | None, sample_blocks) -> "ShardedArrowSpace":
    """The distributed build on rows already placed: stage-1 centroids
    (``"serial"``: the scan over ``sample_blocks()``; ``"lloyd"``: the
    mesh-reduced Lloyd), the F×F graph from them, then the index."""
    from matternet_rs_tpu_torch.ops import laplacian as lap_ops
    from matternet_rs_tpu_torch.parallel.clustering import distributed_lloyd

    if centroids == "serial":
        cents = _serial_centroids(sample_blocks(), n, k_clusters, radius, centroid_sample)
    elif centroids == "lloyd":
        cents, counts, _ = distributed_lloyd(mesh, Xs, n, k_clusters, iters=lloyd_iters)
        cents = cents[counts > 0]
    else:
        raise ValueError(f"centroids must be 'lloyd' or 'serial', got {centroids!r}")
    gl = lap_ops.build_laplacian_from_k_cluster(
        torch.from_numpy(np.asarray(cents, np.float32)).to(mesh.lead), graph_params, n_items=n)
    return ShardedArrowSpace._index(mesh, Xs, n, gl, taumode)


@dataclasses.dataclass
class ShardedArrowSpace:
    mesh: Mesh
    X: ShardedArray              # [N_pad, F]
    norms: ShardedArray          # [N_pad]
    lambdas: ShardedArray        # [N_pad], normalised to [0, 1]
    gl: GraphLaplacian           # on the mesh's lead device
    n_items: int
    taumode: TauMode = TAUDEFAULT
    min_lambdas: float = 0.0
    range_lambdas: float = 1.0
    projection: object | None = None     # ImplicitProjection for original-width queries
    # Energy mode: query λ is the nearest sub-centroid's.
    sub_centroids: torch.Tensor | None = None
    subcentroid_lambdas: np.ndarray | None = None
    _search_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    # The per-slot int8 sketch of the quantised tiers (lazy): one
    # attribute, so a reader never pairs one sketch with another's mult.
    _i8_pair: tuple | None = dataclasses.field(default=None, repr=False)
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock, repr=False,
                                              compare=False)

    # ------------------------------------------------------------------
    @classmethod
    def _index(cls, mesh: Mesh, Xs: ShardedArray, n: int, gl: GraphLaplacian,
               taumode: TauMode) -> "ShardedArrowSpace":
        """λ per slot against the replicated graph, normalised globally."""
        gl = _graph_on(gl, mesh.lead, nnodes=n)
        raw = sharded_taumode_lambdas(mesh, Xs, _taumode_graph(gl), taumode.mode,
                                      taumode.param, route_n=n)
        lam, mn, rng = _normalize_sharded_lambdas(mesh, raw, n)
        return cls(mesh=mesh, X=Xs, norms=_row_norms(mesh, Xs), lambdas=lam, gl=gl,
                   n_items=n, taumode=taumode, min_lambdas=mn, range_lambdas=rng)

    @classmethod
    def from_arrowspace(cls, aspace, gl: GraphLaplacian, n_devices: int | None = None,
                        mesh: Mesh | None = None) -> "ShardedArrowSpace":
        """Shard a built single-card index over the mesh (``mesh`` for a
        prebuilt one, e.g. 2-D)."""
        mesh = mesh if mesh is not None else make_mesh(n_devices)
        lead = mesh.lead
        return cls(
            mesh=mesh, X=shard_items(mesh, aspace.data), norms=shard_items(mesh, aspace.norms),
            lambdas=shard_items(mesh, aspace.lambdas), gl=_graph_on(gl, lead),
            n_items=aspace.nitems, taumode=aspace.taumode, min_lambdas=aspace.min_lambdas,
            range_lambdas=aspace.range_lambdas, projection=aspace.projection,
            sub_centroids=None if aspace.sub_centroids is None else aspace.sub_centroids.to(lead),
            subcentroid_lambdas=aspace.subcentroid_lambdas,
        )

    @classmethod
    def from_shards(cls, shards: Sequence[np.ndarray], gl: GraphLaplacian,
                    taumode: TauMode = TAUDEFAULT, n_devices: int | None = None,
                    mesh: Mesh | None = None) -> "ShardedArrowSpace":
        """Distributed build from per-host blocks and a graph: each slot
        receives only its rows, λ per slot, global min/max. The result
        equals the single-card index of the concatenated rows."""
        mesh = mesh if mesh is not None else make_mesh(n_devices)
        n = sum(int(np.asarray(s).shape[0]) for s in shards)
        f = int(np.asarray(shards[0]).shape[1])
        g = _taumode_graph(gl).shape[0]
        if f != g:
            raise ValueError(
                f"shard feature dim {f} must match the graph's {g} "
                "(project shards before a distributed build when using JL reduction)"
            )
        return cls._index(mesh, shard_items_from_blocks(mesh, shards), n, gl, taumode)

    @classmethod
    def distributed_build(cls, shards: Sequence[np.ndarray], graph_params, k_clusters: int,
                          taumode: TauMode = TAUDEFAULT, n_devices: int | None = None,
                          mesh: Mesh | None = None, lloyd_iters: int = 10,
                          centroids: str = "serial", radius: float = 25.0,
                          centroid_sample: int | None = None) -> "ShardedArrowSpace":
        """The whole build over the mesh: per-host blocks → sharded rows →
        stage-1 centroids → the F×F graph (replicated) → λ per slot →
        global stats. ``centroids="serial"`` (default) runs the serial
        builder's radius-gated scan over the first ``centroid_sample`` rows
        in block order (all rows: the serial builder's order, so the index
        ranks as the serial build); ``"lloyd"`` the mesh-reduced Lloyd
        (nothing N-sized on one host; its centroids differ from the
        scan's)."""
        mesh = mesh if mesh is not None else make_mesh(n_devices)
        n = sum(int(np.asarray(s).shape[0]) for s in shards)
        Xs = shard_items_from_blocks(mesh, shards)
        return build_from_rows(mesh, Xs, n, graph_params, k_clusters, taumode, lloyd_iters,
                               centroids, radius, centroid_sample, lambda: iter(shards))

    # ------------------------------------------------------------------
    def _queries(self, queries) -> torch.Tensor:
        Q = torch.as_tensor(np.asarray(queries, np.float32) if not isinstance(queries, torch.Tensor)
                            else queries, dtype=torch.float32).to(self.mesh.lead)
        return Q[None, :] if Q.ndim == 1 else Q

    def prepare_query_lambda(self, query) -> float:
        """One query's normalised λ (through the batch path, B = 1)."""
        return float(self.prepare_query_lambdas_batch(query)[0])

    def prepare_query_lambdas_batch(self, queries) -> torch.Tensor:
        """Query λ ``[B]`` on the lead device. Energy mode: the nearest
        sub-centroid's λ by ``‖q‖² + ‖c‖² − 2⟨q, c⟩`` (a full-f32 product,
        as the reference's mesh path; no ``[B, S, F]`` difference).
        Eigen mode: the routed λ against the graph, normalised and
        clipped. Original-width queries are projected when the graph (or
        the sub-centroids) live in the reduced space."""
        Q = self._queries(queries)
        p = self.projection
        if self.sub_centroids is not None and self.subcentroid_lambdas is not None:
            c = self.sub_centroids
            Qlam = p.project(Q) if (p is not None and Q.shape[-1] == p.original_dim
                                    and c.shape[-1] == p.reduced_dim) else Q
            d = (torch.sum(Qlam * Qlam, dim=-1, keepdim=True) + torch.sum(c * c, dim=-1)[None, :]
                 - 2.0 * mm(Qlam, c.T))
            sc = torch.from_numpy(np.asarray(self.subcentroid_lambdas, np.float32)).to(Q.device)
            return sc[torch.argmin(d, dim=1)]
        graph = _taumode_graph(self.gl)
        if p is not None and Q.shape[-1] == p.original_dim and graph.shape[0] == p.reduced_dim:
            Q = p.project(Q)
        if Q.shape[-1] != graph.shape[0]:
            raise ValueError(
                f"Query dimension {Q.shape[-1]} doesn't match index dimension {graph.shape[0]}"
            )
        return tmo.query_lambdas(Q, graph, self.taumode.mode, self.taumode.param,
                                 self.min_lambdas, self.range_lambdas)[1]

    def _cached(self, key, make):
        fn = self._search_cache.get(key)
        if fn is None:
            fn = self._search_cache[key] = make()
        return fn

    @staticmethod
    def _listed(idx, sc) -> list[tuple[int, float]]:
        idx, sc = idx.cpu().numpy(), sc.cpu().numpy()
        return [(int(i), float(s)) for i, s in zip(idx, sc) if np.isfinite(s)]

    def search(self, query, k: int, alpha: float = 0.7,
               query_lambda: float | None = None) -> list[tuple[int, float]]:
        """Distributed blended top-k of one query (exact against the
        single-card scan); the two-stage merge on a 2-D mesh."""
        if query_lambda is None:
            query_lambda = self.prepare_query_lambda(query)
        if "slice" in self.mesh.axis_names:
            fn = self._cached(("slice", k), lambda: make_multislice_search(self.mesh, self.n_items, k))
        else:
            fn = self._cached(k, lambda: make_sharded_search(self.mesh, self.n_items, k))
        return self._listed(*fn(self.X, self.norms, self.lambdas,
                                np.asarray(query, np.float32), query_lambda, alpha))

    def _ensure_int8(self):
        """The per-slot int8 sketch and dequant multiplier
        (:func:`..core.quantize_rows` on each slot's rows; a padded zero row
        quantises to ``(0, mult = 0)``)."""
        pair = self._i8_pair
        if pair is None:
            with self._lock:
                pair = self._i8_pair
                if pair is None:
                    q = local_map(self.mesh, lambda _, Xl: quantize_rows(Xl), self.X)
                    pair = (sharded(self.mesh, [t[0] for t in q], self.X.shape),
                            sharded(self.mesh, [t[1] for t in q], (self.X.shape[0],)))
                    self._i8_pair = pair
        return pair

    def search_batch(self, queries, k: int, alpha=0.7, quantized: bool | str = False,
                     candidates: int | None = None, recall_target: float = 0.95):
        """Batched distributed search: query λ in one batch, per-slot
        scoring, one merge. Returns numpy ``(indices [B, k], scores [B,
        k])`` with global ids; exact scores on every tier.

        ``quantized``: ``False`` the exact f32 tier; ``"int8_rescored"``,
        ``"bf16x3_rescored"``, ``"int8"`` a per-slot reduced-precision scan
        with an exact rescore of the slot's top-``candidates`` (per slot,
        default ``max(4k, 32)``) and the merge of exact scores; ``"auto"``
        and ``"int8_auto"`` route as the single-card tiers do. The batch is
        padded to a power of two, at least 8, on the quantised tiers.
        ``bf16_rescored`` and the bare bf16 scan (``True``) are not
        offered on the mesh."""
        Q = self._queries(queries)
        q_lams = self.prepare_query_lambdas_batch(Q)
        if quantized is False:
            fn = self._cached(("batch", k),
                              lambda: make_sharded_search_batch(self.mesh, self.n_items, k))
            idx, sc = fn(self.X, self.norms, self.lambdas, Q, q_lams, alpha)
            return idx.cpu().numpy(), sc.cpu().numpy()
        if quantized not in SHARDED_TIERS:
            raise ValueError(
                f"sharded quantized tier {quantized!r} not supported: expected False or one "
                f"of {sorted(SHARDED_TIERS)} (bf16_rescored is dominated by int8_rescored and "
                "is not offered on the mesh)"
            )
        b = Q.shape[0]
        b_pad = max(8, 1 << max(b - 1, 1).bit_length())
        if b_pad != b:
            Q = torch.nn.functional.pad(Q, (0, 0, 0, b_pad - b))
            q_lams = torch.nn.functional.pad(q_lams, (0, b_pad - b))
        if quantized == "auto":
            if recall_target > 0.9875:
                quantized = "bf16x3_rescored"
            elif recall_target > 0.875 or b_pad >= 1024:
                quantized = "int8"
            else:
                quantized = "int8_rescored"
        elif quantized == "int8_auto":
            quantized = "int8" if b_pad >= 1024 else "int8_rescored"
        n_local = self.X.per
        c = candidates if candidates is not None else max(4 * k, 32)
        c = max(min(c, n_local), min(k, n_local))
        cc = min(1 << (c - 1).bit_length(), n_local)
        fn = self._cached(("batchq", quantized, k, cc), lambda: make_sharded_search_batch_quantized(
            self.mesh, self.n_items, k, cc, quantized))
        a = _alpha_vector(alpha, b_pad, Q.device)
        if quantized in ("int8", "int8_rescored"):
            X8, mult = self._ensure_int8()
            idx, sc = fn(self.X, X8, mult, self.norms, self.lambdas, Q, q_lams, a)
        else:
            idx, sc = fn(self.X, self.norms, self.lambdas, Q, q_lams, a)
        return idx[:b].cpu().numpy(), sc[:b].cpu().numpy()

    def spectral_embedding(self, k_eig: int, params=None, iters: int = 100, reverse_k=None,
                           seed: int = 0):
        """Ring-kNN item graph over the mesh, then distributed LOBPCG:
        ``(eigenvalues [k_eig], vectors [n_items, k_eig])``."""
        from matternet_rs_tpu_torch.parallel.knn_graph import (
            distributed_knn_ell_laplacian,
            distributed_lobpcg,
        )

        params = params or self.gl.graph_params
        ell = distributed_knn_ell_laplacian(self.mesh, self.X, self.n_items, params,
                                            reverse_k=reverse_k)
        return distributed_lobpcg(self.mesh, ell, k_eig, iters=iters, seed=seed)

    def search_hybrid(self, query, k: int, alpha: float = 0.7,
                      query_lambda: float | None = None) -> list[tuple[int, float]]:
        """Distributed hybrid search (exact against the single-card one)."""
        if query_lambda is None:
            query_lambda = self.prepare_query_lambda(query)
        fn = self._cached(("hybrid", k),
                          lambda: make_sharded_hybrid_search(self.mesh, self.n_items, k))
        return self._listed(*fn(self.X, self.norms, self.lambdas, np.asarray(query, np.float32),
                                query_lambda, alpha))

    def range_search(self, query, eps: float,
                     query_lambda: float | None = None) -> list[tuple[int, float]]:
        """Every item with ``λq − λi ≤ eps`` (signed), in id order, with
        that distance: per slot, then one count and the matches gathered."""
        if query_lambda is None:
            query_lambda = self.prepare_query_lambda(query)
        per = self.X.per
        n = self.n_items

        def body(slot, ll):
            ql = torch.tensor(query_lambda, dtype=torch.float32, device=ll.device)
            dist, mask = so.range_search_mask(ll, ql, torch.tensor(eps, dtype=torch.float32,
                                                                   device=ll.device))
            mask = mask & ((slot * per + torch.arange(per, device=ll.device)) < n)
            return dist, mask

        outs = local_map(self.mesh, body, self.lambdas)
        count = int(psum(self.mesh, [o[1].sum() for o in outs]))
        if count == 0:
            return []
        dist = all_gather(self.mesh, [o[0] for o in outs], tiled=True)
        mask = all_gather(self.mesh, [o[1] for o in outs], tiled=True)
        idx = torch.nonzero(mask)[:, 0]
        return [(int(i), float(d)) for i, d in zip(idx.cpu().numpy(), dist[idx].cpu().numpy())]

    def search_energy(self, query, k: int,
                      query_lambda: float | None = None) -> list[tuple[int, float]]:
        """Distributed pure-λ-distance search, ascending, with the cosine
        tie-break (the energy query semantics)."""
        if query_lambda is None:
            query_lambda = self.prepare_query_lambda(query)
        fn = self._cached(("energy", k),
                          lambda: make_sharded_energy_search(self.mesh, self.n_items, k))
        return self._listed(*fn(self.X, self.norms, self.lambdas, np.asarray(query, np.float32),
                                query_lambda))

    # ------------------------------------------------------------------
    # Persistence in the streaming index's store format: one directory
    # serves load_from_store, StreamingIndex.load and the CLI.
    # ------------------------------------------------------------------
    def to_store(self, directory) -> None:
        """Write this index as a shard store, one slot's block at a time
        (nothing N-sized on the host). A stale sketch pair is removed
        before the new corpus is written."""
        from pathlib import Path

        from matternet_rs_tpu_torch.index.streaming import (
            LAMBDA_FILE,
            SKETCH_FILE,
            SKETCH_META_FILE,
            StreamingIndex,
        )
        from matternet_rs_tpu_torch.storage import shards as shard_store

        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        (directory / SKETCH_FILE).unlink(missing_ok=True)
        (directory / SKETCH_META_FILE).unlink(missing_ok=True)
        shard_store.write_shards(_device_blocks(self.X, self.n_items), directory)
        # The store keeps raw λ: back from the normalised values (exact but
        # for values clipped at the bounds, which land on the bounds).
        with open(directory / LAMBDA_FILE, "wb") as fh:
            for lam in _device_blocks(self.lambdas, self.n_items):
                raw = self.min_lambdas + lam.astype(np.float64) * self.range_lambdas
                fh.write(raw.astype(np.float32).tobytes())
        StreamingIndex(
            directory=directory, gl=_graph_on(self.gl, torch.device("cpu")),
            taumode=self.taumode, min_lambdas=self.min_lambdas,
            range_lambdas=self.range_lambdas, n_items=self.n_items,
            n_features=int(self.X.shape[1]),
            sub_centroids=None if self.sub_centroids is None else self.sub_centroids.cpu().numpy(),
            subcentroid_lambdas=self.subcentroid_lambdas, projection=self.projection,
        )._save_meta()

    @classmethod
    def load_from_store(cls, directory, n_devices: int | None = None,
                        mesh: Mesh | None = None) -> "ShardedArrowSpace":
        """Resume a stored index over the mesh, nothing recomputed."""
        from pathlib import Path

        from matternet_rs_tpu_torch.index.streaming import LAMBDA_FILE, StreamingIndex
        from matternet_rs_tpu_torch.storage import shards as shard_store

        mesh = mesh if mesh is not None else make_mesh(n_devices)
        si = StreamingIndex.load(directory, device=mesh.lead)
        Xs, n = shard_store.shard_items_from_store(mesh, directory)
        raw = np.fromfile(Path(directory) / LAMBDA_FILE, np.float32)
        lam = np.clip((raw.astype(np.float64) - si.min_lambdas) / si.range_lambdas,
                      0.0, 1.0).astype(np.float32)
        return cls(
            mesh=mesh, X=Xs, norms=_row_norms(mesh, Xs), lambdas=shard_items(mesh, lam),
            gl=si.gl, n_items=n, taumode=si.taumode, min_lambdas=si.min_lambdas,
            range_lambdas=si.range_lambdas, projection=si.projection,
            sub_centroids=None if si.sub_centroids is None
            else torch.from_numpy(np.asarray(si.sub_centroids, np.float32)).to(mesh.lead),
            subcentroid_lambdas=si.subcentroid_lambdas,
        )


def _device_blocks(arr: ShardedArray, n_items: int):
    """A sharded array's rows in global order, one slot's block on the
    host at a time, cut at ``n_items``. Every slot must be this process's:
    on a mesh that spans processes a store written from one process would
    be truncated, so that raises."""
    if any(t is None for t in arr.shards):
        raise RuntimeError(
            f"to_store covers {arr.per * len(arr.mesh.local_slots)}/{n_items} rows — this "
            "process's slots do not span the corpus (a mesh across processes). Persist from "
            "one process's mesh, or write per-process stores and merge them explicitly."
        )
    emitted = 0
    for t in arr.shards:
        take = min(t.shape[0], n_items - emitted)
        if take <= 0:
            break
        emitted += take
        yield t[:take].cpu().numpy()
