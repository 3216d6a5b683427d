"""ArrowSpace: the item store and λ index (twin of the reference's
``core.py``, eigen mode with the exact and the quantised search tiers).

Holds the ``[N, F]`` data as a tensor on one device, per-item normalised λ,
the normalisation stats and the sorted-λ index. ``search_batch`` computes
every query's λ in one batch, folds in the normalisation and runs the
requested tier: the exact scan (flat → tile-max → fused, see
:mod:`..ops.search`), the bf16-copy scan (``quantized=True``), the int8
pool-cut tier or one of the maxima-first rescored tiers (kernels D and E),
with the reference's ``auto`` routing. ``approx=True`` selects exactly
(:mod:`..ops.search` says why). With a JL projection the data stays
F-wide and the scores are cosine over it; λ (items and queries) is taken
of the projected rows against the r × r graph. Energy mode (an index
built by :func:`..energymaps.build_energy`) takes each query's λ from its
nearest sub-centroid and serves it through the same tiers.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Optional

import numpy as np
import torch

from matternet_rs_tpu_torch.backend import resolve_device
from matternet_rs_tpu_torch.graph import GraphLaplacian
from matternet_rs_tpu_torch.index.sorted import SortedLambdas
from matternet_rs_tpu_torch.ops import scores as score_ops
from matternet_rs_tpu_torch.ops import search as search_ops
from matternet_rs_tpu_torch.ops import taumode as taumode_ops
from matternet_rs_tpu_torch.ops._mm import mm, mm_bf16
from matternet_rs_tpu_torch.ops.csr import ell_from_dense_laplacian
from matternet_rs_tpu_torch.ops.kernels import tilemax as tmk
from matternet_rs_tpu_torch.reduction import ImplicitProjection
from matternet_rs_tpu_torch.utils import profiling

log = logging.getLogger(__name__)

TAU_FLOOR = taumode_ops.TAU_FLOOR
TILEMAX_MIN_N = search_ops.TILEMAX_MIN_N

# Every named scan tier the reference's search_batch accepts; an unknown
# name raises instead of falling through to another tier.
QUANT_TIERS = frozenset(
    {"auto", "int8", "int8_auto", "int8_rescored", "bf16_rescored",
     "bf16x3_rescored"}
)
# Tiers the reference gates behind allow_low_recall=True.
LOW_RECALL_TIERS = frozenset({"bf16_rescored"})
# The maxima-first tiers, padded to at least 8 queries as in the reference.
RESCORED_TIERS = frozenset({"int8_rescored", "bf16_rescored", "bf16x3_rescored"})


def _normalize_lambdas(raw: torch.Tensor):
    """Min-max to [0, 1] (max folded from 0.0, range floored at 1e-9).
    Returns ``(normalized, (min, max, range))``."""
    mn = torch.min(raw)
    mx = torch.clamp(torch.max(raw), min=0.0)
    rng = torch.clamp(mx - mn, min=1e-9)
    stats = torch.stack([mn, mx, rng]).cpu().tolist()
    return (raw - mn) / rng, stats


def _routed_batched_search(X, norms, lams, Q, q_lams, k: int, alphas, mask_from=None):
    """Exact batched search: the tile-max selection from TILEMAX_MIN_N
    rows, from FUSED_TILEMAX_MIN_N when the fused path applies, else flat.
    Rows ≥ ``mask_from`` (a mesh slot's padding) score -inf."""
    n = X.shape[0]
    tilemax_n = (
        search_ops.FUSED_TILEMAX_MIN_N
        if search_ops.fused_fast_path(n, X.shape[1], Q.shape[0], X.dtype, min(k, n),
                                      device=X.device)
        else TILEMAX_MIN_N
    )
    if n >= tilemax_n:
        return search_ops.search_lambda_aware_tilemax(X, norms, lams, Q, q_lams, k, alphas,
                                                      mask_from=mask_from)
    return search_ops.flat_topk(X, norms, lams, Q, q_lams, k, alphas, mask_from)


def quantize_rows(X: torch.Tensor):
    """Per-row symmetric int8 quantisation: ``q8 = round(x/scale)`` (half
    to even, as ``jnp.rint``), ``scale = maxabs/127`` (1 for a zero row);
    ``mult = scale/|x|`` turns a raw int8 dot into the cosine numerator
    over |x| (0 for zero rows, the guarded-cosine convention). Returns
    ``(q8 [N, F] int8, mult [N] float32)``. ``maxabs/127`` is taken as
    ``maxabs · f32(1/127)``, the product XLA compiles the reference's
    division by the constant into, and the norm's square root is rounded
    correctly as XLA's is (PyTorch's vectorised CPU ``sqrt`` can be 1 ulp
    off)."""
    maxabs = torch.amax(torch.abs(X), dim=1)
    norms = torch.sqrt(torch.sum(X * X, dim=1).double()).float()
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=X.device)
    scale = torch.where(maxabs > 0, maxabs * inv127, torch.ones_like(maxabs))
    q8 = torch.round(X / scale[:, None]).to(torch.int8)
    mult = score_ops.guarded_cosine(scale, norms)
    return q8, mult


def _poolcut_scan(Xscan, X, norms, lams, Q, q_lams, k: int, cand: int, alphas, scan_rn=None,
                  mask_from=None):
    """The pool-cut tiers: one pass over ``Xscan`` — the int8 sketch (a
    plain ``[B, N]`` bf16 product on the f32 widening, the dequantised
    cosine with ``scan_rn`` its multiplier), the bf16 copy or the f32 rows
    (the guarded cosine with the exact f32 norms) —, the blend, the
    top-``cand`` candidates (tile-max pruned from ``TILEMAX_MIN_N``), their
    f32 rows rescored at full f32, the top-``k`` of those. Rows ≥
    ``mask_from`` score -inf in the scan and again after the rescore (an
    exact rescore of a padded zero row is 0 + λ-sim)."""
    qn = torch.sqrt(torch.sum(Q * Q, dim=-1))
    if Xscan.dtype == torch.int8:
        cos = score_ops.dequant_cosine(mm_bf16(Q, Xscan.T), scan_rn[None, :],
                                       score_ops.norm_floor(qn[:, None]))
        scores = score_ops.blend(cos, lams[None, :], q_lams[:, None], alphas[:, None])
    else:
        scores = tmk.blended_scores(search_ops._scan_dots_batch(Xscan, Q), norms, lams, qn,
                                    q_lams, alphas)
    scores = search_ops.mask_rows(scores, mask_from)
    if X.shape[0] >= TILEMAX_MIN_N:
        _, idx = search_ops.tilemax_topk(scores, cand)
    else:
        _, idx = search_ops.topk_stable(scores, cand)
    d2 = mm(X[idx], Q[:, :, None])[..., 0]                     # [B, cand]
    s2 = tmk.blend(d2, norms[idx] * qn[:, None], lams[idx], q_lams[:, None], alphas[:, None])
    top, sel = search_ops.topk_stable(search_ops.mask_rows(s2, mask_from, idx), k)
    return torch.gather(idx, 1, sel), top


def _rescored_tier(Xscan, X, norms, lams, Q, q_lams, k: int, cand: int, alphas, scan_rn=None,
                   mask_from=None):
    """The maxima-first tiers: kernel D scans ``Xscan`` (the int8 sketch
    with ``scan_rn`` its dequant multiplier, the bf16 copy, or the f32
    corpus at bf16x3), kernel E rescores the selected slabs exactly. Off
    the envelope, the pool-cut scan at the same precision — except f32,
    whose fallback takes full-f32 dots (the reference's
    ``Precision.HIGH`` is plain f32 off the TPU). Rows ≥ ``mask_from``
    score -inf."""
    n, f = Xscan.shape
    if search_ops.fused_rescored_path(n, f, Q.shape[0], min(k, n), cand):
        return search_ops.fused_scan_rescored(Xscan, X, norms, lams, Q, q_lams, k, cand,
                                              alphas, scan_rn=scan_rn, mask_from=mask_from)
    return _poolcut_scan(Xscan, X, norms, lams, Q, q_lams, k, cand, alphas, scan_rn, mask_from)


def _alpha_vector(alpha, b_pad: int, device) -> torch.Tensor:
    """Scalar-or-[B] alpha → padded ``[b_pad]`` float32 vector
    (:func:`..ops.scores.alpha_vector`); a copy from the host counts as a sync."""
    if (alpha.device.type == "cpu" if isinstance(alpha, torch.Tensor) else np.ndim(alpha)):
        profiling.count_sync(device)          # host values copied to the device
    return score_ops.alpha_vector(alpha, b_pad, device)


@dataclasses.dataclass(frozen=True)
class TauMode:
    """τ-selection policy: ``median()`` (default), ``mean()``,
    ``fixed(t)``, ``percentile(p)``."""

    mode: int = taumode_ops.TAU_MEDIAN
    param: float = 0.0

    @classmethod
    def median(cls) -> "TauMode":
        return cls(taumode_ops.TAU_MEDIAN)

    @classmethod
    def mean(cls) -> "TauMode":
        return cls(taumode_ops.TAU_MEAN)

    @classmethod
    def fixed(cls, t: float) -> "TauMode":
        return cls(taumode_ops.TAU_FIXED, float(t))

    @classmethod
    def percentile(cls, p: float) -> "TauMode":
        return cls(taumode_ops.TAU_PERCENTILE, float(p))

    @property
    def name(self) -> str:
        return {
            taumode_ops.TAU_FIXED: "fixed",
            taumode_ops.TAU_MEDIAN: "median",
            taumode_ops.TAU_MEAN: "mean",
            taumode_ops.TAU_PERCENTILE: "percentile",
        }[self.mode]


TAUDEFAULT = TauMode.median()


class UndecidableQueryError(ValueError):
    """Raised when a query's raw λ is ~0."""


@dataclasses.dataclass
class ArrowItem:
    """One row (float64 on the host) with its λ: the reference's handle
    for single-item computations."""

    item: np.ndarray
    lam: float = 0.0

    def __post_init__(self):
        self.item = np.asarray(self.item, np.float64)

    def __len__(self) -> int:
        return len(self.item)

    def norm(self) -> float:
        return float(np.linalg.norm(self.item))

    def dot(self, other: "ArrowItem") -> float:
        if len(self) != len(other):
            raise ValueError("Dimension mismatch")
        return float(self.item @ np.asarray(other.item))

    def cosine_similarity(self, other) -> float:
        o = np.asarray(other.item if isinstance(other, ArrowItem) else other, np.float64)
        denom = np.linalg.norm(self.item) * np.linalg.norm(o)
        return float(self.item @ o / denom) if denom > 1e-12 else 0.0

    def euclidean_distance(self, other: "ArrowItem") -> float:
        return float(np.linalg.norm(self.item - np.asarray(other.item)))

    def scale(self, factor: float) -> None:
        self.item = self.item * factor

    def add(self, other: "ArrowItem") -> None:
        self.item = self.item + np.asarray(other.item)

    def lambda_component_similarity(self, other: "ArrowItem") -> float:
        """``1 − min(|Δλ|, 1)``."""
        return 1.0 - min(abs(self.lam - other.lam), 1.0)

    def lambda_similarity(self, other: "ArrowItem", alpha: float) -> float:
        """``α·cos + (1−α)·(1 − min(|Δλ|, 1))``."""
        return (alpha * self.cosine_similarity(other)
                + (1.0 - alpha) * self.lambda_component_similarity(other))


@dataclasses.dataclass
class ArrowSpace:
    """Item store + λ index."""

    data: torch.Tensor                   # [N, F] on the space's device
    nfeatures: int
    nitems: int
    taumode: TauMode = TAUDEFAULT

    signals: Optional[torch.Tensor] = None   # F×F spectral Laplacian
    lambdas: Optional[torch.Tensor] = None   # [N] normalised λ
    lambdas_sorted: Optional[object] = None

    min_lambdas: float = -1.0
    max_lambdas: float = -1.0
    range_lambdas: float = -1.0

    n_clusters: int = 0
    cluster_assignments: Optional[np.ndarray] = None
    cluster_sizes: Optional[np.ndarray] = None
    cluster_radius: float = 0.0

    # JL projection: λ is taken of the projected rows when the graph is
    # r × r; the data keeps its F columns.
    projection: Optional[ImplicitProjection] = None
    reduced_dim: Optional[int] = None
    extra_reduced_dim: bool = False

    # Energy mode (energymaps.build_energy): each item's sub-centroid, the
    # sub-centroids [S, F'] on the device, their normalised λ [S] (host,
    # float64 as built) and the items' L2 norms, read by the energy scores.
    centroid_map: Optional[np.ndarray] = None
    sub_centroids: Optional[torch.Tensor] = None
    subcentroid_lambdas: Optional[np.ndarray] = None
    item_norms: Optional[torch.Tensor] = None

    _norms: Optional[torch.Tensor] = None
    # IVF layout for the pruned searches (index/ivf.py), if built.
    ivf: Optional[object] = None
    # ELL form of ``signals`` beyond SPARSE_F_THRESHOLD, with the signals
    # tensor it was extracted from (a replaced ``signals`` re-extracts).
    _signals_ell: Optional[tuple] = None
    # bf16 corpus copy for the quantized=True and bf16_rescored scans.
    _data_bf16: Optional[torch.Tensor] = None
    # (int8 sketch [N, F], dequant multiplier [N]) as one attribute, so a
    # concurrent reader never sees a sketch with another sketch's multiplier.
    _i8_pair: Optional[tuple] = None
    # Guards the lazy copies above: two searches racing a first quantised
    # call would otherwise both build one (twice the transient memory).
    _sketch_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )
    # Derived caches, each keyed by the object it was made from: the
    # largest equal-λ group of a λ tensor, the sub-centroid λ on the
    # device, a host sorted index's device copies (the banded energy scan).
    _tie_group_cache: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)
    _sc_lams_cache: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)
    _banded_sorted_cache: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                              compare=False)

    # The lock is per-process state: left out of pickles and copies, made
    # anew on the copy.
    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_sketch_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._sketch_lock = threading.Lock()

    @classmethod
    def from_items(cls, items, taumode: TauMode = TAUDEFAULT, device=None) -> "ArrowSpace":
        """``device=None`` places the data on the CUDA card (raises
        without one); pass ``device="cpu"`` for the CPU. A float32 tensor
        already on that device is taken as it is, not copied."""
        dev = resolve_device(device)
        if isinstance(items, torch.Tensor):
            data = items.to(dev, torch.float32)
        else:
            data = torch.from_numpy(np.array(items, np.float32)).to(dev)
        if data.ndim != 2 or data.shape[0] < 2:
            raise ValueError("need at least two item rows")
        return cls(data=data, nfeatures=int(data.shape[1]),
                   nitems=int(data.shape[0]), taumode=taumode)

    @classmethod
    def empty_with_projection(cls, proj_data: dict, nrows: int, ncols: int,
                              taumode: Optional[TauMode] = None, device=None) -> "ArrowSpace":
        """An empty space carrying the projection of a typed config map (the
        format of ``storage.parquet.arrowspace_config_typed``). Raises
        ``ValueError`` for ``extra_reduced_dim``, as the reference does."""
        if proj_data.get("extra_reduced_dim"):
            raise ValueError("Reconstructing with extra dim reduction is not implemented")
        sp = cls(
            data=torch.zeros((0, int(ncols)), dtype=torch.float32, device=resolve_device(device)),
            nfeatures=int(ncols), nitems=int(nrows), taumode=taumode or TAUDEFAULT,
        )
        if proj_data.get("projection_original_dim") is not None:
            sp.projection = ImplicitProjection(
                int(proj_data["projection_original_dim"]), int(proj_data["reduced_dim"]),
                int(proj_data.get("projection_seed") or 0),
            )
            sp.reduced_dim = int(proj_data["reduced_dim"])
        return sp

    @property
    def device(self) -> torch.device:
        return self.data.device

    def drop_data(self) -> None:
        """Free the item matrix once it is persisted: λ, the sorted index
        and the metadata stay; searches over the features need a reload."""
        log.info("Freeing raw input memory, should have been persisted to file")
        self.data = torch.zeros((0, self.nfeatures), dtype=torch.float32, device=self.device)
        self._norms = None
        self._data_bf16 = None
        self._i8_pair = None
        self.ivf = None

    def get_item(self, i: int) -> tuple[np.ndarray, float]:
        """Row ``i`` (host copy) and its normalised λ (0 before λ)."""
        lam = float(self.lambdas[i]) if self.lambdas is not None else 0.0
        return self.data[i].cpu().numpy(), lam

    def cluster_of(self, i: int) -> Optional[int]:
        """Item ``i``'s build cluster, None for a dropped outlier or when no
        clustering ran."""
        if self.cluster_assignments is None or i >= len(self.cluster_assignments):
            return None
        c = int(self.cluster_assignments[i])
        return None if c < 0 else c

    # -- mutation ---------------------------------------------------------
    # Every mutation assigns a new ``data`` tensor (as the reference's
    # ``.at[].set``) and drops the caches made from the rows: the row
    # norms, the bf16 copy and the int8 sketch (the last two would
    # otherwise keep serving the quantised tiers the old row).
    def _invalidate_row_caches(self) -> None:
        """Drop the row-derived caches; in energy mode refresh
        ``item_norms``, which the energy scores read."""
        self._norms = None
        self._data_bf16 = None
        self._i8_pair = None
        if self.item_norms is not None:
            self.item_norms = torch.sqrt(torch.sum(self.data * self.data, dim=1))

    def _replace_row(self, i: int, row: torch.Tensor) -> None:
        data = self.data.clone()
        data[i] = row
        self.data = data
        self._invalidate_row_caches()

    def recompute_lambdas(self, gl: GraphLaplacian) -> None:
        """λ of every item against ``gl`` (kernel A from ``KERNEL_MIN_N``
        rows), then the sorted index again if there is one."""
        self.compute_taumode(gl)
        if self.lambdas_sorted is not None:
            self.build_lambdas_sorted()

    def set_item(self, i: int, values) -> None:
        """Replace item ``i``'s row. λ is not recomputed: follow with
        :meth:`recompute_lambdas` (the methods below do)."""
        if not 0 <= i < self.nitems:
            raise ValueError(f"item index out of bounds: i={i}")
        v = torch.as_tensor(values, dtype=torch.float32, device=self.device)
        if tuple(v.shape) != (self.nfeatures,):
            raise ValueError(f"item values must be shape ({self.nfeatures},), got {tuple(v.shape)}")
        self._replace_row(i, v)

    def superpose_items(self, a: int, b: int, gl: GraphLaplacian) -> None:
        """``item[a] += item[b]``, then λ of every item."""
        if not (0 <= a < self.nitems and 0 <= b < self.nitems):
            raise ValueError(f"item indices out of bounds: a={a}, b={b}")
        self._replace_row(a, self.data[a] + self.data[b])
        self.recompute_lambdas(gl)

    def mul_items(self, a: int, b: int, gl: GraphLaplacian) -> None:
        """``item[a] *= item[b]`` elementwise, then λ of every item."""
        if not (0 <= a < self.nitems and 0 <= b < self.nitems):
            raise ValueError(f"item indices out of bounds: a={a}, b={b}")
        self._replace_row(a, self.data[a] * self.data[b])
        self.recompute_lambdas(gl)

    def scale_item(self, a: int, scalar: float, gl: GraphLaplacian) -> None:
        """``item[a] *= scalar`` (taken in float32), then λ of every item."""
        if not 0 <= a < self.nitems:
            raise ValueError(f"item index out of bounds: a={a}")
        self._replace_row(a, self.data[a] * torch.tensor(scalar, dtype=torch.float32,
                                                          device=self.device))
        self.recompute_lambdas(gl)

    def _projects(self, x: torch.Tensor, graph) -> bool:
        """Whether λ of ``x`` is taken of its projection: an original-width
        ``x`` against the r × r graph."""
        p = self.projection
        return (p is not None and x.shape[-1] == p.original_dim
                and graph.shape[0] == p.reduced_dim)

    @property
    def norms(self) -> torch.Tensor:
        if self._norms is None or self._norms.shape[0] != self.data.shape[0]:
            self._norms = torch.sqrt(torch.sum(self.data * self.data, dim=-1))
        return self._norms

    # -- λ computation / normalisation --------------------------------
    def graph_for_taumode(self, gl: GraphLaplacian):
        """Precomputed signals when present, else the Laplacian. Beyond
        ``SPARSE_F_THRESHOLD`` features, or for an ELL-backed graph, the
        graph is served in exact ELL form, cached: extraction makes a full
        ``[F, F]`` pass and reads a scalar back from the device, which per
        query would dominate serving."""
        if self.signals is not None:
            if self.signals.shape[0] > taumode_ops.SPARSE_F_THRESHOLD:
                cached = self._signals_ell
                if cached is None or cached[0] is not self.signals:
                    cached = (self.signals,
                              ell_from_dense_laplacian(profiling.to_device(self.signals,
                                                                           self.device)))
                    self._signals_ell = cached
                return cached[1]
            return profiling.to_device(self.signals, self.device)
        if gl.is_ell_backed or gl.matrix.shape[0] > taumode_ops.SPARSE_F_THRESHOLD:
            return gl.ell()
        return profiling.to_device(gl.matrix, self.device)

    def compute_taumode(self, gl: GraphLaplacian) -> None:
        """Raw λ for all items, then min-max normalisation. With a JL
        projection and an r × r graph, λ is that of the projected rows
        (one full-f32 product); the stored data stays F-wide."""
        graph = self.graph_for_taumode(gl)
        X = self.data
        if self._projects(X, graph):
            X = self.projection.project(X)
        raw = taumode_ops.taumode_lambdas_auto(X, graph, self.taumode.mode, self.taumode.param)
        self.update_lambdas(raw)

    def update_lambdas(self, raw: torch.Tensor) -> None:
        raw = torch.as_tensor(raw, dtype=torch.float32, device=self.device)
        if int(raw.shape[0]) != self.nitems:
            raise ValueError("lambda length mismatch")
        lam_norm, (mn, mx, rng) = _normalize_lambdas(raw)
        self.min_lambdas, self.max_lambdas, self.range_lambdas = mn, mx, rng
        self.lambdas = lam_norm
        log.debug("lambdas updated: n=%d raw_min=%.6f raw_max=%.6f range=%.6f",
                  self.nitems, mn, mx, rng)

    def normalise_query_lambda(self, raw_lambda: float) -> float:
        """Same transform as the batch normalisation, clamped to [0, 1]."""
        return float(
            np.clip((raw_lambda - self.min_lambdas) / self.range_lambdas, 0.0, 1.0)
        )

    def _require_lambdas(self) -> None:
        if self.lambdas is None:
            raise RuntimeError(
                "taumode lambdas not computed: call compute_taumode(gl) "
                "(or build via ArrowSpaceBuilder) before searching"
            )

    def build_lambdas_sorted(self, on_device: bool | None = None) -> None:
        """Sorted-λ index: on the device for a CUDA space, else on the host."""
        if self.lambdas is None:
            raise ValueError("compute lambdas first")
        if on_device is None:
            on_device = self.lambdas.is_cuda
        if on_device:
            self.lambdas_sorted = SortedLambdas.build_on_device(self.lambdas)
        else:
            self.lambdas_sorted = SortedLambdas.build_from(self.lambdas.cpu().numpy())

    def max_lambda_tie_group(self) -> int:
        """Size of the largest run of equal (float32) λ: it sizes the banded
        energy search's window, which must cover the equal-λ group that
        straddles rank k. Cached per λ tensor (λ tensors are replaced,
        never changed in place)."""
        self._require_lambdas()
        cache = self._tie_group_cache
        if cache is not None and cache[0] is self.lambdas:
            return cache[1]
        lam = profiling.to_host(self.lambdas).numpy()
        out = int(np.unique(lam, return_counts=True)[1].max()) if lam.size else 0
        self._tie_group_cache = (self.lambdas, out)
        return out

    # -- energy mode ------------------------------------------------------
    @property
    def _energy(self) -> bool:
        return self.sub_centroids is not None and self.subcentroid_lambdas is not None

    def _subcentroid_lambdas_dev(self) -> torch.Tensor:
        """The sub-centroid λ as float32 on the space's device, cached per
        host array."""
        cache = self._sc_lams_cache
        if cache is None or cache[0] is not self.subcentroid_lambdas:
            lam = np.asarray(self.subcentroid_lambdas, np.float32)
            cache = (self.subcentroid_lambdas, profiling.to_device(torch.from_numpy(lam),
                                                                   self.device))
            self._sc_lams_cache = cache
        return cache[1]

    def _project_queries(self, Q: torch.Tensor) -> torch.Tensor:
        """``Q [B, F]`` through the space's projection, recorded as the span
        ``search.project`` (attrs ``f_in``, ``f_out``)."""
        p = self.projection
        with profiling.span("search.project", f_in=p.original_dim, f_out=p.reduced_dim):
            return p.project(Q)

    def _energy_query(self, Q: torch.Tensor) -> torch.Tensor:
        """Queries in the sub-centroids' space: projected when the space
        was built with the extra reduction, or when they have the original
        width and the sub-centroids the reduced one. ``ValueError`` unless
        the widths then agree."""
        p = self.projection
        Qe = Q
        if self.extra_reduced_dim or (
                p is not None and Q.shape[-1] == p.original_dim
                and self.sub_centroids.shape[-1] == p.reduced_dim):
            Qe = self._project_queries(Q)
        if Qe.shape[-1] != self.sub_centroids.shape[-1]:
            raise ValueError(
                f"Query dimension {Q.shape[-1]} doesn't match "
                f"sub-centroid dimension {self.sub_centroids.shape[-1]}"
            )
        return Qe

    def _nearest_subcentroids(self, Qe: torch.Tensor) -> torch.Tensor:
        """Each row's nearest sub-centroid ``[B]``, by the direct difference
        ``Σ(c − q)²`` (the reference's form on this path), in row blocks of
        at most 2²⁶ ``[b, S, F]`` elements; ties take the first."""
        sub_c = self.sub_centroids
        blk = max(1, (1 << 26) // max(sub_c.numel(), 1))
        out = [torch.argmin(torch.sum((sub_c[None] - Qe[s:s + blk, None, :]) ** 2, dim=-1), dim=1)
               for s in range(0, Qe.shape[0], blk)]
        return torch.cat(out)

    def _nearest_subcentroid_lambdas(self, Qe: torch.Tensor) -> torch.Tensor:
        """λ ``[B]`` of each query's nearest sub-centroid."""
        return self._subcentroid_lambdas_dev()[self._nearest_subcentroids(Qe)]

    # -- query preparation --------------------------------------------
    def project_query(self, query) -> torch.Tensor:
        """The query in the λ space: projected with a projection, else as
        given. ``ValueError`` unless it has the original width."""
        q = torch.from_numpy(np.array(query, np.float32)).to(self.device)
        if q.shape[-1] != self.nfeatures:
            raise ValueError(
                f"Query dimension {q.shape[-1]} doesn't match index "
                f"original dimension {self.nfeatures}"
            )
        return self.projection.project(q) if self.projection else q

    def prepare_query_item(self, query, gl: GraphLaplacian) -> float:
        """The query's normalised λ (of its projection, when the space has
        one and the query has the original width). Raises
        :class:`UndecidableQueryError` when its raw λ is ~0, ``ValueError``
        on a non-finite value or a dimension mismatch. Energy mode returns
        the nearest sub-centroid's λ as it is (``gl`` unused)."""
        q_host = np.asarray(query, np.float32)
        if not np.all(np.isfinite(q_host)):
            raise ValueError("query item has non-finite values")
        q = torch.from_numpy(q_host.copy()).to(self.device)
        if self._energy:
            return float(self._nearest_subcentroid_lambdas(self._energy_query(q[None, :]))[0])
        if self.projection is not None and q.shape[-1] == self.projection.original_dim:
            q = self.projection.project(q)
        graph = self.graph_for_taumode(gl)
        if q.shape[-1] != graph.shape[0]:
            raise ValueError(
                f"Query dimension {q_host.shape[-1]} doesn't match index "
                f"dimension {graph.shape[0]} (original F={self.nfeatures})"
            )
        raw = float(taumode_ops.synthetic_lambda(
            q, graph, self.taumode.mode, self.taumode.param
        ))
        if abs(raw) <= 1e-12:
            raise UndecidableQueryError(
                "Check your eps parameter for the builder; the query item may "
                "be out of context for the dataset (undecidable): raw λ is 0.0"
            )
        if np.isfinite(self.range_lambdas) and self.range_lambdas > 0:
            return self.normalise_query_lambda(raw)
        return raw

    # -- quantised corpus copies ---------------------------------------
    def enable_quantized_scan(self) -> None:
        """Cache a bf16 copy of the corpus (half the scan's read) for
        ``quantized=True`` and ``"bf16_rescored"``."""
        self._data_bf16 = self.data.to(torch.bfloat16)

    def _scan_corpus(self, quantized) -> torch.Tensor:
        if not quantized:
            return self.data
        if self._data_bf16 is None or self._data_bf16.shape[0] != self.data.shape[0]:
            with self._sketch_lock:
                if self._data_bf16 is None or self._data_bf16.shape[0] != self.data.shape[0]:
                    self.enable_quantized_scan()
        return self._data_bf16

    def enable_int8_scan(self) -> None:
        """Cache the int8 sketch and its dequant multiplier
        (:func:`quantize_rows`) for the int8 tiers; one attribute write, so
        readers see the whole old pair or the whole new one."""
        self._i8_pair = quantize_rows(self.data)

    def _ensure_int8(self):
        pair = self._i8_pair
        if pair is None or pair[0].shape[0] != self.data.shape[0]:
            with self._sketch_lock:
                pair = self._i8_pair
                if pair is None or pair[0].shape[0] != self.data.shape[0]:
                    self.enable_int8_scan()
                    pair = self._i8_pair
        return pair

    def _int8_cand(self, k: int, candidates: Optional[int]) -> int:
        """Candidate-pool width of the quantised tiers: ``max(4k, 32)`` by
        default, clamped to ``[k, N]``, padded to a power of two."""
        c = candidates if candidates is not None else max(4 * k, 32)
        c = max(min(c, self.nitems), min(k, self.nitems))
        return min(1 << (c - 1).bit_length(), self.nitems)

    # -- search ---------------------------------------------------------
    def search_lambda_aware(self, query, query_lambda: float, k: int,
                            alpha: float = 0.7, approx: bool = False,
                            recall_target: float = 0.95,
                            quantized: bool = False) -> list[tuple[int, float]]:
        """Single-query top-k by blended score, over the bf16 copy with
        ``quantized``. ``approx`` selects exactly (``ops/search.py`` says
        why), so ``recall_target`` is accepted, in the reference's place,
        and bounds nothing."""
        self._require_lambdas()
        if query_lambda == 0.0:
            raise ValueError(
                "Lambda of the item is 0.0, prepare the item before searching"
            )
        q = torch.from_numpy(np.array(query, np.float32)).to(self.device)
        idx, sc = search_ops.search_lambda_aware(
            self._scan_corpus(quantized), self.norms, self.lambdas, q, query_lambda, k,
            alpha, approx=approx, recall_target=recall_target,
        )
        return [(int(i), float(s)) for i, s in zip(idx.cpu(), sc.cpu())]

    def search_batch(self, queries, gl: GraphLaplacian, k: int, alpha=0.7,
                     approx: bool = False, return_raw: bool = False,
                     quantized: bool | str = False, candidates: Optional[int] = None,
                     recall_target: float = 0.95, allow_low_recall: bool = False):
        """Batched search: every query's λ in one batch (closed form, or
        kernel A from 32768 queries) with the normalisation folded in, then
        the requested tier. The batch is padded to the next power of two
        (the reference's compiled-shape discipline, kept so both packages
        see the same batch shapes), and to at least 8 queries for the
        maxima-first tiers. ``alpha`` is a scalar or a per-query ``[B]``
        vector. Returns numpy ``(indices [B, k], scores [B, k])``, plus the
        raw query λ with ``return_raw``. In energy mode each query's λ is
        its nearest sub-centroid's (``gl`` unused), and the same tiers
        serve it.

        ``quantized``: ``False`` — the exact f32 scan; ``True`` — the same
        scan over a bf16 copy; ``"int8"`` — pool-cut: an int8-sketch scan
        keeps the top-``candidates`` (default ``max(4k, 32)``) per query,
        rescored exactly; ``"int8_rescored"``, ``"bf16_rescored"`` (gated
        by ``allow_low_recall``), ``"bf16x3_rescored"`` — maxima-first:
        kernel D scans the int8 sketch, the bf16 copy or the f32 corpus at
        bf16x3 and keeps 128-row sub-tile maxima, kernel E rescores every
        row of the selected slabs exactly (the pool-cut scan off the
        envelope); ``"auto"`` — by ``recall_target`` over the reference's
        measured ladder: above 0.9875 bf16x3_rescored, above 0.875 (or
        from 1024 queries) int8 with approx, else int8_rescored;
        ``"int8_auto"`` — int8_rescored below 1024 queries, int8 with
        approx from 1024. Every tier returns exact scores of the ids it
        names. An unknown tier and an ungated low-recall tier raise
        ``ValueError``.

        Under a running ``torch.profiler`` the call records the spans
        (:func:`..utils.profiling.span`) ``search.batch`` (attrs ``mode``,
        ``tier``, ``b``, ``b_pad``, ``k``) and within it ``search.input``,
        ``search.query_lambda`` (eigen mode: attr ``route``, the query λ's
        route as :func:`..ops.taumode.query_lambdas` took it; with a JL
        projection its child ``search.project``, attrs ``f_in`` and
        ``f_out``, the queries' projection), ``search.scan`` and
        ``search.fetch``; each host–device sync counts against the span it
        falls in."""
        with profiling.span("search.batch", mode="energy" if self._energy else "eigen",
                            k=k) as root:
            with profiling.span("search.input"):
                self._require_lambdas()
                if isinstance(quantized, str) and quantized not in QUANT_TIERS:
                    raise ValueError(
                        f"unknown quantized tier {quantized!r}: expected a bool or "
                        f"one of {sorted(QUANT_TIERS)}"
                    )
                if quantized in LOW_RECALL_TIERS and not allow_low_recall:
                    raise ValueError(
                        f"quantized tier {quantized!r} is dominated on clustered "
                        "corpora; pass allow_low_recall=True only for "
                        "spread/normalized corpora"
                    )
                Q = profiling.to_device(torch.from_numpy(np.array(queries, np.float32)),
                                        self.device)
                if Q.ndim == 1:
                    Q = Q[None, :]
                if not self._energy:
                    graph = self.graph_for_taumode(gl)
                    projects = self._projects(Q, graph)
                    if not projects and Q.shape[-1] != graph.shape[0]:
                        raise ValueError(
                            f"Query dimension {Q.shape[-1]} doesn't match index "
                            f"dimension {graph.shape[0]}"
                        )
                b = Q.shape[0]
                b_pad = 1 << max(b - 1, 1).bit_length() if b > 1 else 1
                alphas = _alpha_vector(alpha, b_pad, self.device)

                if quantized == "auto":
                    if recall_target > 0.9875:
                        quantized = "bf16x3_rescored"
                    elif recall_target > 0.875 or b_pad >= 1024:
                        quantized, approx = "int8", True
                    else:
                        quantized = "int8_rescored"
                if quantized == "int8_auto":
                    if b_pad >= 1024:
                        quantized, approx = "int8", True
                    else:
                        quantized = "int8_rescored"
                if quantized in RESCORED_TIERS and b_pad < 8:
                    alphas = _alpha_vector(alphas, 8, self.device)
                    b_pad = 8
                if b_pad != b:
                    Q = torch.nn.functional.pad(Q, (0, 0, 0, b_pad - b))
            root.set(tier=quantized if isinstance(quantized, str) else
                     ("bf16" if quantized else "exact"), b=b, b_pad=b_pad)

            with profiling.span("search.query_lambda") as qspan:
                if self._energy:
                    # The nearest sub-centroid's λ, already normalised: the
                    # reference folds it in with mn = 0 and rng = 1, an identity.
                    raw = q_lams = self._nearest_subcentroid_lambdas(self._energy_query(Q))
                else:
                    # λ of the projected batch when the graph is r × r; the
                    # scores below stay on the F-wide rows.
                    Qw = self._project_queries(Q) if projects else Q
                    raw, q_lams, route = taumode_ops.query_lambdas(
                        Qw, graph, self.taumode.mode, self.taumode.param,
                        self.min_lambdas, self.range_lambdas)
                    qspan.set(route=route)

            with profiling.span("search.scan"):
                X, norms, lams = self.data, self.norms, self.lambdas
                kk = min(k, self.nitems)
                if quantized == "int8":
                    X8, mult = self._ensure_int8()
                    idx, sc = _poolcut_scan(X8, X, norms, lams, Q, q_lams, kk,
                                            self._int8_cand(k, candidates), alphas, scan_rn=mult)
                elif quantized in RESCORED_TIERS:
                    if quantized == "int8_rescored":
                        Xscan, rn = self._ensure_int8()
                    else:
                        Xscan, rn = (X if quantized == "bf16x3_rescored"
                                     else self._scan_corpus(True)), None
                    idx, sc = _rescored_tier(Xscan, X, norms, lams, Q, q_lams, kk,
                                             self._int8_cand(k, candidates), alphas, scan_rn=rn)
                else:
                    idx, sc = _routed_batched_search(self._scan_corpus(quantized), norms, lams,
                                                     Q, q_lams, k, alphas)

            with profiling.span("search.fetch"):
                out = (profiling.to_host(idx[:b]).numpy(), profiling.to_host(sc[:b]).numpy())
                if return_raw:
                    out += (profiling.to_host(raw[:b]).numpy(),)
        return out

    # -- append ---------------------------------------------------------
    def add_items(self, new_rows, gl: GraphLaplacian) -> None:
        """Append rows to a built index; the graph is not rebuilt. Eigen
        mode: λ of the new rows against the existing graph with the
        existing normalisation, clamped to [0, 1] (as queries are; kernel A
        from ``KERNEL_MIN_N`` rows). Energy mode: each new row takes its
        nearest sub-centroid (direct L2 difference, first index) and that
        sub-centroid's λ; ``centroid_map`` and ``item_norms`` grow. Then
        the IVF layout and the sorted index, where they exist, are built
        again."""
        new = torch.as_tensor(new_rows, dtype=torch.float32, device=self.device)
        if new.ndim == 1:
            new = new[None, :]
        if new.shape[-1] != self.nfeatures:
            raise ValueError(
                f"new items have dimension {new.shape[-1]}, index has {self.nfeatures}"
            )
        p = self.projection
        if self._energy:
            Xe = new
            if (p is not None and Xe.shape[-1] == p.original_dim
                    and self.sub_centroids.shape[-1] == p.reduced_dim):
                Xe = p.project(Xe)
            nearest = self._nearest_subcentroids(Xe)
            lam_new = self._subcentroid_lambdas_dev()[nearest]
            self.centroid_map = np.concatenate([self.centroid_map, nearest.cpu().numpy()])
            if self.item_norms is not None:
                self.item_norms = torch.cat([self.item_norms,
                                             torch.sqrt(torch.sum(new * new, dim=-1))])
        else:
            graph = self.graph_for_taumode(gl)
            X = self.projection.project(new) if self._projects(new, graph) else new
            raw = taumode_ops.taumode_lambdas_auto(X, graph, self.taumode.mode, self.taumode.param)
            lam_new = score_ops.normalised(raw, self.min_lambdas, self.range_lambdas)
        self.data = torch.cat([self.data, new], dim=0)
        self.lambdas = torch.cat([self.lambdas, lam_new])
        self.nitems = int(self.data.shape[0])
        self._norms = None
        self._data_bf16 = None
        self._i8_pair = None
        if self.ivf is not None:
            # The layout does not know the new rows: build it again.
            self.build_ivf_index(bucket_size=self.ivf.bucket_size)
        if self.lambdas_sorted is not None:
            self.build_lambdas_sorted()

    # -- λ-band, hybrid, sorted and range searches -------------------------
    def _query(self, query) -> torch.Tensor:
        return torch.as_tensor(query, dtype=torch.float32, device=self.device)

    def search_lambda_aware_hybrid(self, query, query_lambda: float, k: int,
                                   alpha: float = 0.7) -> list[tuple[int, float]]:
        """Hybrid top-k (:func:`..ops.search.search_lambda_aware_hybrid`);
        −inf slots are left out."""
        self._require_lambdas()
        if k == 0:
            return []
        idx, sc = search_ops.search_lambda_aware_hybrid(
            self.data, self.norms, self.lambdas, self._query(query), float(query_lambda), k, alpha)
        return [(int(i), float(v)) for i, v in zip(idx.cpu(), sc.cpu()) if np.isfinite(float(v))]

    def search_linear_sorted(self, query, gl: GraphLaplacian, k: int):
        """The sorted index's band around the query's λ, first ``k`` by λ."""
        self._require_lambdas()
        q_lambda = self.prepare_query_item(query, gl)
        return self.lambdas_sorted.range_bylambda(q_lambda, k, gl.graph_params.p)

    def search_k_nearest_by_lambda(self, query, gl: GraphLaplacian, k: int,
                                   base_delta: float | None = None, growth: float = 1.7,
                                   max_multiplier: float = 10.0) -> list[tuple[int, float]]:
        """Expanding-window ``k`` nearest by |Δλ| over the sorted index."""
        if self.lambdas_sorted is None:
            raise ValueError("build_lambdas_sorted() first")
        q_lambda = self.prepare_query_item(query, gl)
        return self.lambdas_sorted.k_nearest_by_lambda(
            q_lambda, k, gl.graph_params.p, base_delta, growth, max_multiplier)

    def search_lambda_banded(self, query, query_lambda: float, k: int, alpha: float = 0.7,
                             window: int = 4096) -> list[tuple[int, float]]:
        """Blended top-k over ``window`` rows of the sorted-λ order around
        the query (:func:`..ops.search.search_lambda_banded`)."""
        if self.lambdas_sorted is None:
            raise ValueError("build_lambdas_sorted() first")
        sl = self.lambdas_sorted
        if isinstance(sl, SortedLambdas):
            s_lam = torch.as_tensor(np.asarray(sl.sorted_lambdas, np.float32), device=self.device)
            s_idx = torch.as_tensor(sl.sorted_indices, dtype=torch.int64, device=self.device)
        else:
            s_lam, s_idx = sl.sorted_lambdas_dev, sl.sorted_indices_dev
        idx, sc = search_ops.search_lambda_banded(
            self.data, self.norms, s_lam, s_idx, self._query(query), query_lambda, k, alpha, window)
        return [(int(i), float(v)) for i, v in zip(idx.cpu(), sc.cpu())]

    def range_search(self, query, query_lambda: float, eps: float):
        """Every item with ``λq − λi ≤ eps`` (signed), with that distance."""
        self._require_lambdas()
        dist, mask = search_ops.range_search_mask(
            self.lambdas, torch.tensor(query_lambda, dtype=torch.float32, device=self.device),
            torch.tensor(eps, dtype=torch.float32, device=self.device))
        dist = dist.cpu().numpy()
        return [(int(i), float(dist[i])) for i in np.nonzero(mask.cpu().numpy())[0]]

    # -- IVF-pruned search --------------------------------------------------
    def build_ivf_index(self, bucket_size: int = 1024, seed: int = 0):
        """The bucketed IVF layout over the items (:mod:`..index.ivf`),
        centroids from the build's cluster assignments when there are any,
        else k-means."""
        from matternet_rs_tpu_torch.index.ivf import build_ivf

        self.ivf = build_ivf(
            self.data, assignments=self.cluster_assignments,
            n_clusters=self.n_clusters or None, bucket_size=bucket_size, seed=seed,
            lambdas=None if self.lambdas is None else self.lambdas.cpu().numpy(),
        )
        return self.ivf

    def search_lambda_aware_ivf(self, query, query_lambda: float, k: int, alpha: float = 0.7,
                                nprobe: int = 8) -> list[tuple[int, float]]:
        """Blended top-k over the ``nprobe`` best buckets, scored exactly;
        the full scan at ``nprobe`` ≥ the bucket count."""
        from matternet_rs_tpu_torch.index.ivf import _index_arrays, ivf_search

        if self.ivf is None:
            raise ValueError("build_ivf_index() first")
        if query_lambda == 0.0:
            raise ValueError("Lambda of the item is 0.0, prepare the item before searching")
        idx, sc = ivf_search(*_index_arrays(self.ivf), self.data, self.norms, self.lambdas,
                             self._query(query), query_lambda, k, alpha, nprobe)
        return [(int(i), float(v)) for i, v in zip(idx.cpu(), sc.cpu()) if np.isfinite(float(v))]

    def search_batch_ivf(self, queries, gl: GraphLaplacian, k: int, alpha: float = 0.7,
                         nprobe: int = 8):
        """Batched pruned search, the query λ as :meth:`search_batch` takes
        it in eigen mode. Returns numpy ``(indices [B, k], scores [B, k])``;
        slots past the candidates hold −1 and −inf."""
        from matternet_rs_tpu_torch.index.ivf import _index_arrays, ivf_search_batch

        if self.ivf is None:
            raise ValueError("build_ivf_index() first")
        Q = self._query(queries)
        if Q.ndim == 1:
            Q = Q[None, :]
        graph = self.graph_for_taumode(gl)
        Qw = self.projection.project(Q) if self._projects(Q, graph) else Q
        q_lams = taumode_ops.query_lambdas(Qw, graph, self.taumode.mode, self.taumode.param,
                                           self.min_lambdas, self.range_lambdas)[1]
        idx, sc = ivf_search_batch(*_index_arrays(self.ivf), self.data, self.norms, self.lambdas,
                                   Q, q_lams, k, alpha, nprobe)
        return idx.cpu().numpy(), sc.cpu().numpy()
