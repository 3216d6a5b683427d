"""EnergyMaps: the cosine-free energy index (twin of the reference's
``energymaps.py``).

1. **Optical compression** — the centroids projected to 2-D (JL), binned on
   a √budget × √budget grid, the high-norm quantile of each bin trimmed,
   each bin mean-pooled, topped up with the lowest-norm rows;
2. **Bootstrap Laplacian L₀** — the F×F cosine-kernel graph over the
   compressed centroids' feature profiles;
3. **Heat diffusion + split** — ``x' = x - η·L·x`` for ``steps`` full-f32
   products, then the top-dispersion-quantile rows split ±τ along their
   local gradient into sub-centroids;
4. **Energy Laplacian** over the sub-centroids, with per-node energy and
   dispersion in closed form (seven full-f32 products);
5. **λ of the sub-centroids only** (the plain closed form, as the
   reference: a few hundred rows), each item mapped to a sub-centroid
   (nearest by L2, then by λ distance with a cosine tie-break), item
   norms kept;
6. **search_energy** — ascending λ distance, the cosine tie-break where
   ``|Δλ| < 1e-9``; batched, with the reference's banded window over the
   sorted λ.

The energy score is not the blend. On the card the batched full scan
for k ≤ 16 takes the window route (:func:`.ops.kernels.energy_scan.
energy_topk_window`, ``csrc/energy_window.cu``) where the index's sorted-λ
view lies on the card and was sorted from its current λ: each query's tie
band ``|Δλ| < 1e-9`` is one run of the sorted λ, found on the card, and
only the band's dots are taken, by queries grouped by band (a band of a
few queries on a narrow tile that streams its rows once); a row outside
the band scores exactly ``|Δλ|``, so a walk out of the band on each side,
stopped at the first row that cannot rank before the k-th, settles the
answer, bit for bit ``energy_scan``'s (the proof is the kernel's header).
Launches are counted under ``energy_window``; ``window_tally`` reads the
band pairs, dot pairs (and the narrow tiles' share) and walks from a
tally the search never reads.
Without such a view the route is ``energy_scan`` and G's merge, one
streamed pass over all rows. Neither writes a ``[B, N]`` plane or sorts.
Elsewhere (the CPU, k > 16, the banded window, the single-query scans) it
is a full-f32 ``torch.matmul`` followed by the stable top-k
(``lax.top_k``'s order: ties lowest index first). Energy-mode
``ArrowSpace.search_batch`` takes the sub-centroid λ into the blended
tiers and so their kernels (:mod:`.core`). Entry points run on the
devices of the objects they are given; the builder's device for a build.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from matternet_rs_tpu_torch.core import ArrowSpace
from matternet_rs_tpu_torch.graph import GraphLaplacian, GraphParams
from matternet_rs_tpu_torch.index.sorted import DeviceSortedLambdas
from matternet_rs_tpu_torch.ops import laplacian as lap_ops
from matternet_rs_tpu_torch.ops import scores as score_ops
from matternet_rs_tpu_torch.ops import taumode as tm_ops
from matternet_rs_tpu_torch.ops._mm import mm
from matternet_rs_tpu_torch.ops.kernels import energy_scan as esk
from matternet_rs_tpu_torch.ops.knn import knn
from matternet_rs_tpu_torch.ops.search import topk_stable
from matternet_rs_tpu_torch.reduction import ImplicitProjection
from matternet_rs_tpu_torch.utils import profiling

# Items assigned to sub-centroids per chunk: bounds the [chunk, S] buffers.
ASSIGN_CHUNK = 65_536
# The cosine tie-break applies where the λ distance is below this.
TIE_EPS = score_ops.TIE_EPS
# Gathered f32 elements per query block of the banded program (1 GiB).
BANDED_GATHER_ELEMS = 1 << 28


@dataclasses.dataclass
class EnergyParams:
    """The reference's defaults."""

    optical_tokens: Optional[int] = 50
    trim_quantile: float = 0.1
    eta: float = 0.1
    steps: int = 4
    split_quantile: float = 0.9
    neighbor_k: int = 20
    split_tau: float = 0.15
    w_lambda: float = 1.0
    w_disp: float = 0.5
    w_dirichlet: float = 0.25
    candidate_m: int = 32

    @staticmethod
    def compute_adaptive_tokens(nitems: int) -> int:
        """2√N clamped to [100, 2000]."""
        return int(min(max(round(2.0 * np.sqrt(nitems)), 100), 2000))

    @classmethod
    def from_builder(cls, builder) -> "EnergyParams":
        """Adaptive parameters from the builder's λ-graph k and item count."""
        base_k = builder.lambda_k
        neighbor_k = min(max(base_k * 2, 15), 50)
        candidate_m = min(max(neighbor_k * 3, 30), 128)
        nitems = getattr(builder, "nitems", 0) or 0
        if nitems:
            tokens = cls.compute_adaptive_tokens(nitems)
        elif builder.use_dims_reduction:
            tokens = int(min(max(np.ceil(80.0 / builder.rp_eps), 40), 200))
        else:
            tokens = 60
        return cls(optical_tokens=tokens, neighbor_k=neighbor_k, candidate_m=candidate_m)

    @classmethod
    def high_resolution(cls, builder) -> "EnergyParams":
        p = cls.from_builder(builder)
        p.optical_tokens = None
        p.neighbor_k = max(builder.lambda_k * 3, 25)
        p.candidate_m = max(builder.lambda_k * 5, 50)
        p.split_quantile = 0.85
        p.steps = 5
        return p

    @classmethod
    def large_dataset(cls, builder) -> "EnergyParams":
        p = cls.from_builder(builder)
        p.optical_tokens = 100
        p.neighbor_k = min(max(builder.lambda_k, 15), 30)
        p.candidate_m = min(max(builder.lambda_k * 2, 30), 80)
        p.steps = 3
        p.split_quantile = 0.92
        return p


# -- step 2: optical compression ----------------------------------------------


def optical_compress_centroids(centroids: np.ndarray, token_budget: int, trim_quantile: float,
                               seed: int = 0, device=None) -> np.ndarray:
    """At most ``token_budget`` pooled rows of ``centroids [x, F]``: the
    2-D projection on ``device`` (``None`` is the CUDA card), the binning,
    trim and top-up on the host (numpy, as the reference)."""
    x, f = centroids.shape
    if token_budget == 0 or token_budget >= x:
        return centroids.copy()

    xy = ImplicitProjection(f, 2, seed).project(centroids, device).cpu().numpy().astype(np.float64)

    g = int(np.ceil(np.sqrt(token_budget)))
    minx, maxx = xy[:, 0].min(), xy[:, 0].max()
    miny, maxy = xy[:, 1].min(), xy[:, 1].max()
    px = (xy[:, 0] - minx) / (maxx - minx + 1e-9)
    py = (xy[:, 1] - miny) / (maxy - miny + 1e-9)
    bx = np.clip(np.floor(px * g), 0, g - 1).astype(int)
    by = np.clip(np.floor(py * g), 0, g - 1).astype(int)
    bin_ids = by * g + bx

    norms = np.linalg.norm(centroids, axis=1)

    # Rows sorted by (bin, norm): the rank within a bin decides who
    # survives the norm-quantile trim; one np.add.at pools the bins.
    order = np.lexsort((norms, bin_ids))
    sb = bin_ids[order]
    _, starts, counts = np.unique(sb, return_index=True, return_counts=True)
    rank = np.arange(x) - np.repeat(starts, counts)
    cnt_of = np.repeat(counts, counts)
    keep_of = np.where(
        cnt_of > 4,
        # Rust's round (half away from zero), clamped to at least 1.
        np.maximum(np.floor(cnt_of * (1.0 - trim_quantile) + 0.5), 1).astype(int),
        cnt_of,
    )
    kept = rank < keep_of
    kept_rows = order[kept]
    kept_bins = sb[kept]

    sums = np.zeros((g * g, f), np.float64)
    np.add.at(sums, kept_bins, centroids[kept_rows].astype(np.float64))
    kept_counts = np.bincount(kept_bins, minlength=g * g)
    # Past the budget, bins are dropped in bin-id order, as the reference.
    nonempty = np.nonzero(kept_counts)[0][:token_budget]
    pooled = sums[nonempty] / kept_counts[nonempty, None]

    if len(nonempty) < token_budget:
        top_up = np.argsort(norms, kind="stable")[: token_budget - len(nonempty)]
        pooled = np.concatenate([pooled, centroids[top_up].astype(np.float64)])

    return pooled.astype(np.float32)


# -- step 3: bootstrap Laplacian ------------------------------------------------


def bootstrap_centroid_laplacian(centroids, builder) -> GraphLaplacian:
    """F×F cosine-kernel Laplacian over the centroids' feature profiles, on
    the builder's device."""
    centroids = torch.as_tensor(centroids, dtype=torch.float32, device=builder.device)
    x = int(centroids.shape[0])
    params = GraphParams(
        eps=builder.lambda_eps,
        k=min(builder.lambda_k, x - 1),
        topk=min(builder.lambda_topk, 4, x - 1),
        p=2.0,
        sigma=None,
        normalise=builder.normalise,
        sparsity_check=builder.sparsity_check,
    )
    return lap_ops.build_laplacian_matrix(centroids.T.contiguous(), params, n_items=x, energy=True)


# -- step 4: diffusion + dispersion split -----------------------------------------


def _diffusion_kernel(X: torch.Tensor, L: torch.Tensor, eta: float, steps: int) -> torch.Tensor:
    """``x' = x - η·L·x`` per row, ``steps`` times (full-f32 products)."""
    work = X
    for _ in range(steps):
        work = work - eta * mm(work, L.T)
    return work


def _energy_dispersion_kernel(X: torch.Tensor, L: torch.Tensor):
    """Rayleigh λ and the upper-triangle dispersion G of the rows of ``X``
    against the F×F graph, in closed form: G = 2·N₄/T² over each
    undirected edge once."""
    A = torch.clamp(-L, min=0.0)
    A = A - torch.diag(torch.diag(A))
    A2 = A * A
    deg = torch.sum(A, dim=1)
    deg2 = torch.sum(A2, dim=1)

    XL = mm(X, L.T)
    num_e = torch.sum(X * XL, dim=-1)
    den = torch.sum(X * X, dim=-1)
    lam = torch.clamp(
        torch.where(den > 1e-12, num_e / torch.clamp(den, min=1e-12), torch.zeros_like(den)),
        min=0.0)

    X2 = X * X
    X3 = X2 * X
    X4 = X2 * X2
    B1, B2 = mm(X, A), mm(X2, A)
    C1, C2, C3, C4 = mm(X, A2), mm(X2, A2), mm(X3, A2), mm(X4, A2)
    total_both = torch.sum(X2 * deg - 2.0 * X * B1 + B2, dim=-1)
    num4_both = torch.sum(X4 * deg2 - 4.0 * X3 * C1 + 6.0 * X2 * C2 - 4.0 * X * C3 + C4, dim=-1)
    g = torch.where(
        total_both > 2e-12,
        2.0 * num4_both / torch.clamp(total_both * total_both, min=1e-24),
        torch.zeros_like(total_both),
    )
    return lam, torch.clamp(g, 0.0, 1.0)


def node_energy_and_dispersion(X, gl: GraphLaplacian, k: int):
    """``(λ [N], G [N])`` as float64 numpy, on the graph's device (``k``
    is unused by the closed form and kept for the reference's signature)."""
    L = gl.matrix
    X = torch.as_tensor(X, dtype=torch.float32, device=L.device)
    lam, g = _energy_dispersion_kernel(X, L)
    return lam.cpu().numpy().astype(np.float64), g.cpu().numpy().astype(np.float64)


def diffuse_and_split_subcentroids(centroids: np.ndarray, l0: GraphLaplacian,
                                   p: EnergyParams) -> np.ndarray:
    """Diffuse ``centroids [x, F]`` over ``l0``, then split each row at or
    above the ``split_quantile`` of dispersion into a (+, −) pair along its
    direction from the mean of its ``neighbor_k`` nearest rows (one
    batched kNN). Returns the diffused rows followed by the pairs."""
    x, f = centroids.shape
    if l0.matrix.shape[0] != f:
        raise ValueError(f"Laplacian rows {l0.matrix.shape[0]} must match feature count {f}")
    dev = l0.matrix.device
    work = _diffusion_kernel(torch.as_tensor(np.asarray(centroids, np.float32), device=dev),
                             l0.matrix, float(p.eta), int(p.steps))
    work_np = work.cpu().numpy().astype(np.float64)

    _, gini = node_energy_and_dispersion(work, l0, p.neighbor_k)

    g_sorted = np.sort(gini)
    # Rust's round is half away from zero (Python's rounds half to even).
    q_idx = int(np.floor((len(g_sorted) - 1) * p.split_quantile + 0.5))
    thresh = g_sorted[q_idx]

    rows = [work_np]
    to_split = np.nonzero(gini >= thresh)[0]
    k = min(p.neighbor_k, x - 1)
    if to_split.size and x > 1 and k >= 1:
        sel_t = torch.from_numpy(to_split).to(dev)
        _, idx = knn(work[sel_t], work, k=k + 1, metric="sqeuclidean")
        idx = idx.cpu().numpy()                                 # [S, k+1]
        # Drop each row's own index, keep the neighbour order, take k.
        not_self = idx != to_split[:, None]
        sel = np.argsort(~not_self, axis=1, kind="stable")[:, :k]
        nbrs = np.take_along_axis(idx, sel, axis=1)
        mean = work_np[nbrs].mean(axis=1)

        c = work_np[to_split]
        d = c - mean
        n = np.maximum(np.sqrt((d * d).sum(axis=1)), 1e-9)
        direction = d / n[:, None]
        std_loc = np.sqrt(np.mean((d - d.mean(axis=1, keepdims=True)) ** 2, axis=1))
        tau = p.split_tau * np.maximum(std_loc, 1e-6)
        plus = c + tau[:, None] * direction
        minus = c - tau[:, None] * direction
        # (+, −) interleaved per split row.
        rows.append(np.stack([plus, minus], axis=1).reshape(-1, f))

    return np.concatenate(rows, axis=0).astype(np.float32)


# -- step 6: energy Laplacian -----------------------------------------------------


def build_energy_laplacian(sub_centroids, builder, p: EnergyParams):
    """``(L, λ, G)``: the bootstrap graph over the sub-centroids and their
    energy and dispersion."""
    l_boot = bootstrap_centroid_laplacian(sub_centroids, builder)
    lam, gini = node_energy_and_dispersion(sub_centroids, l_boot, max(p.neighbor_k, builder.lambda_k))
    return l_boot, lam, gini


# -- the build --------------------------------------------------------------------


def _assign_chunk(Xc, sc, sc_sq, scn, sc_lam):
    """Sub-centroid of each row of ``Xc``: the nearest by L2 (expanded
    form) gives the row's λ; the row then goes to the sub-centroid nearest
    in λ, the largest cosine among those within 1e-11 of the best."""
    d2 = torch.sum(Xc * Xc, dim=1, keepdim=True) + sc_sq[None, :] - 2.0 * mm(Xc, sc.T)
    item_lambda = sc_lam[torch.argmin(d2, dim=1)]
    lam_dist = torch.abs(item_lambda[:, None] - sc_lam[None, :])
    best_dist = torch.min(lam_dist, dim=1).values
    ties = torch.abs(lam_dist - best_dist[:, None]) < 1e-11
    n_ties = torch.sum(ties, dim=1)
    Xn = Xc / torch.clamp(torch.linalg.norm(Xc, dim=1, keepdim=True), min=1e-12)
    cos = mm(Xn, scn.T)
    masked = torch.where(ties, cos, torch.full_like(cos, -float("inf")))
    return torch.where(n_ties > 1, torch.argmax(masked, dim=1), torch.argmin(lam_dist, dim=1))


def build_energy(builder, rows, energy_params: Optional[EnergyParams] = None):
    """Energy build → ``(ArrowSpace, GraphLaplacian)`` on the builder's
    device; stage seconds in ``builder.last_stage_timings``."""
    rows = np.asarray(rows, np.float32)
    if not builder.use_dims_reduction:
        raise ValueError("When using build_energy, dim reduction is needed")
    if builder.prebuilt_spectral:
        raise ValueError("Spectral mode not compatible with build_energy")

    builder.nitems = rows.shape[0]
    p = energy_params or EnergyParams.from_builder(builder)
    timer = profiling.StageTimer(builder.device)

    with timer.stage("clustering", items=rows.shape[0]):
        aspace, centroids = builder.start_clustering(rows)
        centroids = np.asarray(centroids, np.float32)
    with timer.stage("optical_compression", items=centroids.shape[0]):
        if p.optical_tokens is not None:
            centroids = optical_compress_centroids(
                centroids, p.optical_tokens, p.trim_quantile,
                seed=builder.clustering_seed or 0, device=builder.device,
            )
    with timer.stage("bootstrap_laplacian", items=centroids.shape[1]):
        l0 = bootstrap_centroid_laplacian(centroids, builder)
    with timer.stage("diffuse_split", items=centroids.shape[0]):
        sub_centroids = diffuse_and_split_subcentroids(centroids, l0, p)
    with timer.stage("energy_laplacian", items=sub_centroids.shape[0]):
        gl_energy, _, _ = build_energy_laplacian(sub_centroids, builder, p)

    dev = aspace.device
    with timer.stage("subcentroid_lambdas", items=sub_centroids.shape[0]):
        sc = torch.from_numpy(sub_centroids).to(dev)
        raw = tm_ops.taumode_lambdas(sc, gl_energy.matrix, aspace.taumode.mode, aspace.taumode.param)
        raw_np = raw.cpu().numpy().astype(np.float64)
        mn = float(raw_np.min())
        mx = max(float(raw_np.max()), 0.0)
        rng = max(mx - mn, 1e-9)
        sc_lambdas = (raw_np - mn) / rng
        aspace.sub_centroids = sc
        aspace.subcentroid_lambdas = sc_lambdas
        aspace.min_lambdas, aspace.max_lambdas, aspace.range_lambdas = mn, mx, rng

    with timer.stage("assignment", items=rows.shape[0]):
        X = aspace.data
        if aspace.projection is not None:
            X = aspace.projection.project(X)
        scn = sc / torch.clamp(torch.linalg.norm(sc, dim=1, keepdim=True), min=1e-12)
        sc_sq = torch.sum(sc * sc, dim=1)
        sc_lam = torch.from_numpy(sc_lambdas.astype(np.float32)).to(dev)
        best_idx = torch.cat([
            _assign_chunk(X[s:s + ASSIGN_CHUNK], sc, sc_sq, scn, sc_lam)
            for s in range(0, X.shape[0], ASSIGN_CHUNK)
        ]).cpu().numpy()
        aspace.centroid_map = best_idx.astype(np.int64)
        aspace.lambdas = torch.from_numpy(sc_lambdas[best_idx].astype(np.float32)).to(dev)
        aspace.item_norms = torch.sqrt(torch.sum(aspace.data * aspace.data, dim=1))
        aspace.build_lambdas_sorted()
    builder.last_stage_timings = timer.as_dict()
    return aspace, gl_energy


# -- scoring ------------------------------------------------------------------------


def _query_tensor(aspace: ArrowSpace, queries) -> torch.Tensor:
    Q = profiling.to_device(torch.from_numpy(np.array(queries, np.float32)), aspace.device)
    return Q[None, :] if Q.ndim == 1 else Q


def search_energy(aspace: ArrowSpace, query, gl_energy: GraphLaplacian, k: int,
                  approx: bool = False) -> list[tuple[int, float]]:
    """λ-distance scan with the cosine tie-break, ascending. ``approx``
    selects exactly (the reference's ``approx_max_k`` is a TPU operation;
    off the TPU it returns ``lax.top_k``'s ids)."""
    q_lambda = aspace.prepare_query_item(query, gl_energy)
    Q = _query_tensor(aspace, query)
    ql = torch.tensor([q_lambda], dtype=torch.float32, device=aspace.device)
    scores = esk.energy_scores_plain(aspace.data, aspace.item_norms, aspace.lambdas, Q, ql)[0]
    neg, idx = topk_stable(-scores, min(k, aspace.nitems))
    return [(int(i), float(-s)) for i, s in zip(idx.cpu(), neg.cpu())]


def _batch_query_lambdas(sub_c, sc_lams, Qe):
    """Nearest sub-centroid by L2 in the expanded form (the reference's
    batched form here; ``ArrowSpace.search_batch`` takes the direct
    difference) → its λ."""
    d = (torch.sum(Qe * Qe, dim=-1, keepdim=True) + torch.sum(sub_c * sub_c, dim=-1)[None, :]
         - 2.0 * mm(Qe, sub_c.T))
    return sc_lams[torch.argmin(d, dim=1)]


def _banded_search(X, norms, s_lam, s_idx, Q, q_lams, k: int, cand: int):
    """The banded program: the items nearest a query's λ form a contiguous
    window of the sorted λ, so each query scores the ``2·cand`` rows from
    ``clip(pos − cand, 0, n − 2·cand)`` (``pos`` the left insertion point)
    exactly and keeps the top ``k``. Equal to the full scan whenever the
    window covers the equal-λ group that straddles rank k. Queries go in
    blocks whose gathered ``[b, 2·cand, F]`` rows stay within
    ``BANDED_GATHER_ELEMS`` (the reference gathers the whole batch at once;
    each query's result is the same)."""
    n = s_lam.shape[0]
    step = max(1, BANDED_GATHER_ELEMS // (2 * cand * X.shape[1]))
    arange = torch.arange(2 * cand, device=X.device)[None, :]
    out_i, out_d = [], []
    for s in range(0, Q.shape[0], step):
        Qb, qlb = Q[s:s + step], q_lams[s:s + step]
        pos = torch.searchsorted(s_lam, qlb)                  # side='left'
        win = torch.clamp(pos - cand, 0, n - 2 * cand)[:, None] + arange
        ids = s_idx[win]                                      # [b, 2C]
        qn = torch.sqrt(torch.sum(Qb * Qb, dim=-1))
        dots = torch.bmm(X[ids], Qb[:, :, None])[..., 0]
        cosine = score_ops.energy_cosine(dots, qn[:, None] * norms[ids])
        scores = score_ops.energy_score(torch.abs(qlb[:, None] - s_lam[win]), cosine)
        neg, sel = topk_stable(-scores, k)
        out_i.append(torch.gather(ids, 1, sel))
        out_d.append(-neg)
    return torch.cat(out_i), torch.cat(out_d)


def search_energy_batch(aspace: ArrowSpace, queries, gl_energy: GraphLaplacian, k: int,
                        approx: bool = False, candidates: int | str | None = None):
    """Batched energy search: every query's λ (nearest sub-centroid) in one
    product, then the full scan, or with ``candidates`` the banded window
    (``"auto"``: the largest equal-λ group plus k, banded only while the
    windows of the power-of-two padded batch read at most a tenth of the
    corpus — the reference's routing, so both packages route alike; the
    launch takes the real batch). ``approx`` selects exactly. Returns
    numpy ``(indices [B, k], distances [B, k])`` ascending. Under a running
    ``torch.profiler`` the call records the spans of
    :meth:`ArrowSpace.search_batch`."""
    with profiling.span("search.batch", mode="energy", k=k) as root:
        with profiling.span("search.input"):
            if aspace.sub_centroids is None or aspace.subcentroid_lambdas is None:
                raise ValueError("not an energy-mode index (no sub-centroids)")
            Q = _query_tensor(aspace, queries)
            b = Q.shape[0]
            b_pad = 1 << max(b - 1, 1).bit_length() if b > 1 else 1
            kk = min(k, aspace.nitems)

        with profiling.span("search.query_lambda"):
            Qe = aspace._energy_query(Q)
            sc_lams = aspace._subcentroid_lambdas_dev()
            q_lams = _batch_query_lambdas(aspace.sub_centroids, sc_lams, Qe)

        with profiling.span("search.scan") as scan:
            cand = None
            if candidates is not None:
                if candidates == "auto":
                    cand = aspace.max_lambda_tie_group() + kk
                    if 2 * cand * b_pad > aspace.nitems // 10:
                        cand = aspace.nitems              # the full scan
                else:
                    cand = max(int(candidates), kk)
            banded = cand is not None and 2 * cand <= aspace.nitems
            root.set(tier="banded" if banded else "scan", b=b, b_pad=b_pad)
            if banded:
                scan.set(route="plain")
                s_lam, s_idx = _sorted_lambda_arrays(aspace)
                idx, dist = _banded_search(aspace.data, aspace.item_norms, s_lam, s_idx, Q,
                                           q_lams, kk, cand)
            else:
                view = _window_view(aspace)
                route = esk.route(Q.device, kk, window=view is not None)
                scan.set(route=route)
                if route == "window":
                    idx, dist = esk.energy_topk_window(aspace.data, aspace.item_norms, *view, Q,
                                                       q_lams, kk)
                else:
                    topk = esk.energy_topk if route == "kernel" else esk.energy_topk_plain
                    idx, dist = topk(aspace.data, aspace.item_norms, aspace.lambdas, Q, q_lams, kk)

        with profiling.span("search.fetch"):
            return profiling.to_host(idx).numpy(), profiling.to_host(dist).numpy()


def _window_view(aspace: ArrowSpace):
    """``(sorted λ, item per position)`` of the space's sorted-λ view when
    it lies on a CUDA device and was sorted from the space's current λ
    tensor (mutation and append build it anew; λ tensors are replaced,
    never changed in place), else ``None``: the window route's operands."""
    sl = aspace.lambdas_sorted
    if (isinstance(sl, DeviceSortedLambdas) and sl.source is aspace.lambdas
            and sl.sorted_lambdas_dev.is_cuda):
        return sl.sorted_lambdas_dev, sl.sorted_indices_dev
    return None


def _sorted_lambda_arrays(aspace: ArrowSpace):
    """``(sorted λ [N] float32, item per position [N])`` on the space's
    device, building the sorted index on first use; a host index's device
    copies are cached per index object."""
    if aspace.lambdas_sorted is None:
        aspace.build_lambdas_sorted()
    sl = aspace.lambdas_sorted
    if isinstance(sl, DeviceSortedLambdas):
        return sl.sorted_lambdas_dev, sl.sorted_indices_dev
    cache = aspace._banded_sorted_cache
    if cache is not None and cache[0] is sl:
        return cache[1], cache[2]
    s_lam = profiling.to_device(torch.from_numpy(sl.sorted_lambdas.astype(np.float32)),
                                aspace.device)
    s_idx = profiling.to_device(torch.from_numpy(sl.sorted_indices), aspace.device)
    aspace._banded_sorted_cache = (sl, s_lam, s_idx)
    return s_lam, s_idx


def search_energy_adaptive(aspace: ArrowSpace, query, gl_energy: GraphLaplacian,
                           k: int) -> list[tuple[int, float]]:
    """``w_λ·|Δλ| + w_D·‖q − x‖/‖q‖`` with the weights from the λ range
    (:func:`adaptive_energy_weights`), ascending."""
    w_lambda, w_feat = adaptive_energy_weights(aspace)
    q_lambda = aspace.prepare_query_item(query, gl_energy)
    q = _query_tensor(aspace, query)[0]
    lam_dist = torch.abs(torch.tensor(q_lambda, dtype=torch.float32, device=aspace.device)
                         - aspace.lambdas)
    qn = torch.clamp(torch.sqrt(torch.sum(q * q)), min=1e-9)
    diff = aspace.data - q[None, :]
    feat_dist = torch.sqrt(torch.sum(diff * diff, dim=-1)) / qn
    scores = w_lambda * lam_dist + w_feat * feat_dist
    neg, idx = topk_stable(-scores, min(k, aspace.nitems))
    return [(int(i), float(-s)) for i, s in zip(idx.cpu(), neg.cpu())]


def adaptive_w_lambda(aspace: ArrowSpace) -> float:
    """The λ range mapped linearly onto a weight in [0.5, 2.0]."""
    if aspace.range_lambdas < 1e-9:
        return 0.5
    return 0.5 + 1.5 * aspace.range_lambdas


def adaptive_energy_weights(aspace: ArrowSpace) -> tuple[float, float]:
    w_lambda = adaptive_w_lambda(aspace)
    return w_lambda, 2.5 - w_lambda
