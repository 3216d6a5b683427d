"""ArrowSpace: the item store and λ index (twin of the reference's
``core.py``, eigen mode with the exact search tier).

Holds the ``[N, F]`` data as a tensor on one device, per-item normalised λ,
the normalisation stats and the sorted-λ index. ``search_batch`` computes
every query's λ in one batch, folds in the normalisation and routes the
exact scan flat → tile-max → fused (see :mod:`..ops.search`). The
quantised tiers, energy mode and the JL projection come in later slices
and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from matternet_rs_tpu_torch.backend import resolve_device
from matternet_rs_tpu_torch.graph import ELL_NOT_PORTED, GraphLaplacian
from matternet_rs_tpu_torch.index.sorted import SortedLambdas
from matternet_rs_tpu_torch.ops import search as search_ops
from matternet_rs_tpu_torch.ops import taumode as taumode_ops

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
QUANT_NOT_PORTED = (
    "quantized scan tiers are not ported yet: ROADMAP.md Queue 1 item 6 "
    "(the rescored tiers, slice 3)"
)


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


def _batched_search_normalized(X, norms, lams, Q, raw, mn, rng, k: int, alphas):
    """Search with the query-λ normalisation folded in."""
    q_lams = torch.clamp((raw - mn) / rng, 0.0, 1.0)
    return _routed_batched_search(X, norms, lams, Q, q_lams, k, alphas)


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
    def graph_for_taumode(self, gl: GraphLaplacian) -> torch.Tensor:
        """Precomputed signals when present, else the dense Laplacian."""
        graph = self.signals if self.signals is not None else gl.dense()
        if graph.shape[0] > taumode_ops.SPARSE_F_THRESHOLD:
            raise NotImplementedError(ELL_NOT_PORTED)
        return graph.to(self.device)

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

    # -- search ---------------------------------------------------------
    def search_lambda_aware(self, query, query_lambda: float, k: int,
                            alpha: float = 0.7, approx: bool = False
                            ) -> list[tuple[int, float]]:
        """Single-query exact top-k by blended score."""
        self._require_lambdas()
        if query_lambda == 0.0:
            raise ValueError(
                "Lambda of the item is 0.0, prepare the item before searching"
            )
        q = torch.from_numpy(np.array(query, np.float32)).to(self.device)
        idx, sc = search_ops.search_lambda_aware(
            self.data, self.norms, self.lambdas, q, query_lambda, k, alpha, approx=approx
        )
        return [(int(i), float(s)) for i, s in zip(idx.cpu(), sc.cpu())]

    def search_batch(self, queries, gl: GraphLaplacian, k: int, alpha=0.7,
                     approx: bool = False, return_raw: bool = False,
                     quantized: bool | str = False, allow_low_recall: bool = False):
        """Batched exact search: every query's λ in one batch (closed form,
        or kernel A from 32768 queries) with the normalisation folded in,
        then the routed blended top-k. The batch is padded to the next
        power of two (the reference's compiled-shape discipline, kept so
        both packages see the same batch shapes). ``alpha`` is a scalar or
        a per-query ``[B]`` vector. Returns numpy ``(indices [B, k],
        scores [B, k])``, plus the raw query λ with ``return_raw``.

        ``quantized`` names are validated as in the reference (an unknown
        tier and an ungated low-recall tier raise ``ValueError``); every
        value but ``False`` then raises ``NotImplementedError``."""
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
        if quantized:
            raise NotImplementedError(QUANT_NOT_PORTED)
        if approx:
            raise NotImplementedError(search_ops.APPROX_NOT_PORTED)
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
        if b_pad != b:
            Q = torch.nn.functional.pad(Q, (0, 0, 0, b_pad - b))
        alphas = _alpha_vector(alpha, b_pad, self.device)

        raw = taumode_ops.taumode_lambdas_auto(Q, graph, self.taumode.mode, self.taumode.param)
        mn = torch.tensor(self.min_lambdas, dtype=torch.float32, device=self.device)
        rng = torch.tensor(self.range_lambdas, dtype=torch.float32, device=self.device)
        idx, sc = _batched_search_normalized(
            self.data, self.norms, self.lambdas, Q, raw, mn, rng, k, alphas
        )
        idx, sc = idx[:b].cpu().numpy(), sc[:b].cpu().numpy()
        if return_raw:
            return idx, sc, raw[:b].cpu().numpy()
        return idx, sc
