"""ArrowSpace: the item store and λ index (twin of the reference's
``core.py``, eigen mode with the exact and the quantised search tiers).

Holds the ``[N, F]`` data as a tensor on one device, per-item normalised λ,
the normalisation stats and the sorted-λ index. ``search_batch`` computes
every query's λ in one batch, folds in the normalisation and runs the
requested tier: the exact scan (flat → tile-max → fused, see
:mod:`..ops.search`), the bf16-copy scan (``quantized=True``), the int8
pool-cut tier or one of the maxima-first rescored tiers (kernels D and E),
with the reference's ``auto`` routing. ``approx=True`` selects exactly
(:mod:`..ops.search` says why). Energy mode and the JL projection come in
later slices.
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
from matternet_rs_tpu_torch.ops import search as search_ops
from matternet_rs_tpu_torch.ops import taumode as taumode_ops
from matternet_rs_tpu_torch.ops._mm import mm, mm_bf16
from matternet_rs_tpu_torch.ops.csr import ell_from_dense_laplacian
from matternet_rs_tpu_torch.ops.kernels.tilemax import blend

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


def _routed_batched_search(X, norms, lams, Q, q_lams, k: int, alphas):
    """Exact batched search: the tile-max selection from TILEMAX_MIN_N
    rows, from FUSED_TILEMAX_MIN_N when the fused path applies, else flat."""
    n = X.shape[0]
    tilemax_n = (
        search_ops.FUSED_TILEMAX_MIN_N
        if search_ops.fused_fast_path(X, Q.shape[0], min(k, n))
        else TILEMAX_MIN_N
    )
    if n >= tilemax_n:
        return search_ops.search_lambda_aware_tilemax(X, norms, lams, Q, q_lams, k, alphas)
    return search_ops.search_lambda_aware(X, norms, lams, Q, q_lams, k, alphas)


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
    mult = torch.where(norms > 1e-12, scale / torch.clamp(norms, min=1e-12),
                       torch.zeros_like(norms))
    return q8, mult


def _cand_select_rescore(scores, X, norms, lams, Q, q_lams, qn, alphas, k: int, cand: int):
    """Shared tail of the pool-cut tiers: the top-``cand`` candidates of
    the scan ``scores [B, N]`` (tile-max pruned from ``TILEMAX_MIN_N``),
    their f32 rows rescored at full f32, the top-``k`` of those."""
    if X.shape[0] >= TILEMAX_MIN_N:
        _, idx = search_ops.tilemax_topk(scores, cand)
    else:
        _, idx = search_ops.topk_stable(scores, cand)
    d2 = mm(X[idx], Q[:, :, None])[..., 0]                     # [B, cand]
    s2 = blend(d2, norms[idx] * qn[:, None], lams[idx], q_lams[:, None], alphas[:, None])
    top, sel = search_ops.topk_stable(s2, k)
    return torch.gather(idx, 1, sel), top


def _int8_poolcut_scan(X8, mult, X, norms, lams, Q, q_lams, k: int, cand: int, alphas):
    """Pool-cut int8 scan: one bf16 pass over the int8 sketch (a plain
    ``[B, N]`` product on the f32 widening), per-row dequant to cosine,
    top-``cand`` cut, exact rescore."""
    qn = torch.sqrt(torch.sum(Q * Q, dim=-1))
    dots = mm_bf16(Q, X8.T)
    cos = torch.clamp(dots * mult[None, :] / torch.clamp(qn[:, None], min=1e-12), -1.0, 1.0)
    lam_sim = 1.0 - torch.clamp(torch.abs(lams[None, :] - q_lams[:, None]), max=1.0)
    a = alphas[:, None]
    scores = a * cos + (1.0 - a) * lam_sim
    return _cand_select_rescore(scores, X, norms, lams, Q, q_lams, qn, alphas, k, cand)


def _poolcut_scan(dots, X, norms, lams, Q, q_lams, k: int, cand: int, alphas):
    """Pool-cut tail over scan ``dots [B, N]``: guarded cosine with the
    exact f32 norms, blend, top-``cand`` cut, exact rescore."""
    qn = torch.sqrt(torch.sum(Q * Q, dim=-1))
    scores = blend(dots, norms[None, :] * qn[:, None], lams[None, :], q_lams[:, None],
                   alphas[:, None])
    return _cand_select_rescore(scores, X, norms, lams, Q, q_lams, qn, alphas, k, cand)


def _rescored_tier(Xscan, X, norms, lams, Q, q_lams, k: int, cand: int, alphas, scan_rn=None):
    """The maxima-first tiers: kernel D scans ``Xscan`` (the int8 sketch
    with ``scan_rn`` its dequant multiplier, the bf16 copy, or the f32
    corpus at bf16x3), kernel E rescores the selected slabs exactly. Off
    the envelope, the pool-cut scan at the same precision — except f32,
    whose fallback takes full-f32 dots (the reference's
    ``Precision.HIGH`` is plain f32 off the TPU)."""
    n, f = Xscan.shape
    if search_ops.fused_rescored_path(n, f, Q.shape[0], min(k, n), cand):
        return search_ops.fused_scan_rescored(Xscan, X, norms, lams, Q, q_lams, k, cand,
                                              alphas, scan_rn=scan_rn)
    if Xscan.dtype == torch.int8:
        return _int8_poolcut_scan(Xscan, scan_rn, X, norms, lams, Q, q_lams, k, cand, alphas)
    return _poolcut_scan(search_ops._scan_dots_batch(Xscan, Q), X, norms, lams, Q, q_lams,
                         k, cand, alphas)


def _alpha_vector(alpha, b_pad: int, device) -> torch.Tensor:
    """Scalar-or-[B] alpha → padded ``[b_pad]`` float32 vector."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    if a.ndim == 0:
        return torch.full((b_pad,), float(a), dtype=torch.float32, device=device)
    if a.shape[0] != b_pad:
        a = torch.nn.functional.pad(a, (0, b_pad - a.shape[0]))
    return a


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

    _norms: Optional[torch.Tensor] = None
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
        without one); pass ``device="cpu"`` for the CPU."""
        dev = resolve_device(device)
        data = torch.from_numpy(np.array(items, np.float32)).to(dev)
        if data.ndim != 2 or data.shape[0] < 2:
            raise ValueError("need at least two item rows")
        return cls(data=data, nfeatures=int(data.shape[1]),
                   nitems=int(data.shape[0]), taumode=taumode)

    @property
    def device(self) -> torch.device:
        return self.data.device

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
                              ell_from_dense_laplacian(self.signals.to(self.device)))
                    self._signals_ell = cached
                return cached[1]
            return self.signals.to(self.device)
        if gl.is_ell_backed or gl.matrix.shape[0] > taumode_ops.SPARSE_F_THRESHOLD:
            return gl.ell()
        return gl.matrix.to(self.device)

    def compute_taumode(self, gl: GraphLaplacian) -> None:
        """Raw λ for all items, then min-max normalisation."""
        raw = taumode_ops.taumode_lambdas_auto(
            self.data, self.graph_for_taumode(gl), self.taumode.mode, self.taumode.param
        )
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

    # -- query preparation --------------------------------------------
    def prepare_query_item(self, query, gl: GraphLaplacian) -> float:
        """The query's normalised λ. Raises :class:`UndecidableQueryError`
        when its raw λ is ~0, ``ValueError`` on a non-finite value or a
        dimension mismatch."""
        q_host = np.asarray(query, np.float32)
        if not np.all(np.isfinite(q_host)):
            raise ValueError("query item has non-finite values")
        graph = self.graph_for_taumode(gl)
        if q_host.shape[-1] != graph.shape[0]:
            raise ValueError(
                f"Query dimension {q_host.shape[-1]} doesn't match index "
                f"dimension {graph.shape[0]} (original F={self.nfeatures})"
            )
        q = torch.from_numpy(q_host.copy()).to(self.device)
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
                            quantized: bool = False) -> list[tuple[int, float]]:
        """Single-query top-k by blended score, over the bf16 copy with
        ``quantized``; ``approx`` selects exactly."""
        self._require_lambdas()
        if query_lambda == 0.0:
            raise ValueError(
                "Lambda of the item is 0.0, prepare the item before searching"
            )
        q = torch.from_numpy(np.array(query, np.float32)).to(self.device)
        idx, sc = search_ops.search_lambda_aware(
            self._scan_corpus(quantized), self.norms, self.lambdas, q, query_lambda, k,
            alpha, approx=approx,
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
        raw query λ with ``return_raw``.

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
        ``ValueError``."""
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
        Q = torch.from_numpy(np.array(queries, np.float32)).to(self.device)
        if Q.ndim == 1:
            Q = Q[None, :]
        graph = self.graph_for_taumode(gl)
        if Q.shape[-1] != graph.shape[0]:
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

        raw = taumode_ops.taumode_lambdas_auto(Q, graph, self.taumode.mode, self.taumode.param)
        mn = torch.tensor(self.min_lambdas, dtype=torch.float32, device=self.device)
        rng = torch.tensor(self.range_lambdas, dtype=torch.float32, device=self.device)
        q_lams = torch.clamp((raw - mn) / rng, 0.0, 1.0)
        X, norms, lams = self.data, self.norms, self.lambdas
        kk = min(k, self.nitems)
        if quantized == "int8":
            X8, mult = self._ensure_int8()
            idx, sc = _int8_poolcut_scan(X8, mult, X, norms, lams, Q, q_lams, kk,
                                         self._int8_cand(k, candidates), alphas)
        elif quantized in RESCORED_TIERS:
            if quantized == "int8_rescored":
                Xscan, rn = self._ensure_int8()
            else:
                Xscan, rn = X if quantized == "bf16x3_rescored" else self._scan_corpus(True), None
            idx, sc = _rescored_tier(Xscan, X, norms, lams, Q, q_lams, kk,
                                     self._int8_cand(k, candidates), alphas, scan_rn=rn)
        else:
            idx, sc = _routed_batched_search(self._scan_corpus(quantized), norms, lams, Q,
                                             q_lams, k, alphas)
        idx, sc = idx[:b].cpu().numpy(), sc[:b].cpu().numpy()
        if return_raw:
            return idx, sc, raw[:b].cpu().numpy()
        return idx, sc
