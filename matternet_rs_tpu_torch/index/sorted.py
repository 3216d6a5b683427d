"""Sorted-λ index (twin of the reference's ``index/sorted.py``): one stable
argsort at build time, ``searchsorted`` band queries. Equal-λ ties keep
ascending item index."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SortedLambdas:
    """Host sorted view over per-item λ (normalised to [0, 1])."""

    sorted_lambdas: np.ndarray      # [N] ascending
    sorted_indices: np.ndarray      # [N] item index per position
    std_dev: float

    @classmethod
    def build_from(cls, lambdas) -> "SortedLambdas":
        lambdas = np.asarray(lambdas, dtype=np.float64)
        if lambdas.size == 0:
            raise ValueError("cannot build sorted index from empty lambdas")
        order = np.argsort(lambdas, kind="stable")
        # f32 std-dev around the f32 mean, as the reference computes it.
        mean32 = np.float32(lambdas.sum()) / np.float32(lambdas.size)
        var32 = np.mean((mean32 - lambdas.astype(np.float32)) ** 2, dtype=np.float32)
        return cls(
            sorted_lambdas=lambdas[order],
            sorted_indices=order.astype(np.int64),
            std_dev=float(np.sqrt(var32)),
        )

    @classmethod
    def build_on_device(cls, lambdas: torch.Tensor) -> "DeviceSortedLambdas":
        return DeviceSortedLambdas.build_from(lambdas)

    def range_bylambda(self, lambda_q: float, k: int, p: float) -> list[tuple[int, float]]:
        """Items with λ ∈ [λq - band, λq + band], band = std/2^p, first k
        in ascending-λ order."""
        band = self.std_dev / (2.0 ** p)
        lo = np.searchsorted(self.sorted_lambdas, lambda_q - band, side="left")
        hi = np.searchsorted(self.sorted_lambdas, lambda_q + band, side="right")
        out = [
            (int(i), float(l))
            for i, l in zip(self.sorted_indices[lo:hi], self.sorted_lambdas[lo:hi])
        ]
        return out[:k]

    def to_vec(self) -> list[tuple[float, int]]:
        return [(float(l), int(i)) for l, i in zip(self.sorted_lambdas, self.sorted_indices)]

    def zadd(self, item_index: int, lam: float) -> None:
        """Single sorted insert; equal-λ ties go after existing entries.
        ``std_dev`` stays as built."""
        pos = int(np.searchsorted(self.sorted_lambdas, lam, side="right"))
        self.sorted_lambdas = np.insert(self.sorted_lambdas, pos, lam)
        self.sorted_indices = np.insert(self.sorted_indices, pos, item_index)

    def k_nearest_by_lambda(self, lambda_q: float, k: int, lambda_p: float,
                            base_delta: float | None = None, growth: float = 1.7,
                            max_multiplier: float = 10.0) -> list[tuple[int, float]]:
        """Expanding-window k nearest by |Δλ|."""
        if k == 0 or self.sorted_lambdas.size == 0:
            return []
        delta = abs(base_delta if base_delta is not None
                    else max(self.std_dev * lambda_p, 1e-9))
        growth = growth if np.isfinite(growth) and growth > 1.0 else 1.7
        max_delta = min(delta * max(max_multiplier, 1.0), 1.0)
        while True:
            lo_v, hi_v = max(lambda_q - delta, 0.0), min(lambda_q + delta, 1.0)
            lo = np.searchsorted(self.sorted_lambdas, lo_v, side="left")
            hi = np.searchsorted(self.sorted_lambdas, hi_v, side="right")
            if hi - lo >= k or delta >= max_delta:
                break
            delta = min(delta * growth, max_delta)
        idx = self.sorted_indices[lo:hi]
        lam = self.sorted_lambdas[lo:hi]
        order = np.argsort(np.abs(lam - lambda_q), kind="stable")[:k]
        return [(int(idx[o]), float(lam[o])) for o in order]


class DeviceSortedLambdas:
    """Device-resident sorted λ: a stable ``torch.sort`` at build, band
    queries with ``torch.searchsorted``; only results cross to the host."""

    def __init__(self, sorted_lambdas: torch.Tensor, sorted_indices: torch.Tensor,
                 std_dev: float):
        self.sorted_lambdas_dev = sorted_lambdas
        self.sorted_indices_dev = sorted_indices
        self.std_dev = std_dev
        self._host: SortedLambdas | None = None

    @classmethod
    def build_from(cls, lambdas: torch.Tensor) -> "DeviceSortedLambdas":
        lam = lambdas.to(torch.float32)
        if lam.numel() == 0:
            raise ValueError("cannot build sorted index from empty lambdas")
        sl, order = torch.sort(lam, stable=True)
        mean = lam.mean()
        std = torch.sqrt(torch.mean((mean - lam) ** 2))
        return cls(sl, order, float(std))

    def range_bylambda(self, lambda_q: float, k: int, p: float) -> list[tuple[int, float]]:
        band = self.std_dev / (2.0 ** p)
        bounds = torch.tensor(
            [lambda_q - band, lambda_q + band], dtype=torch.float32,
            device=self.sorted_lambdas_dev.device,
        )
        lo = int(torch.searchsorted(self.sorted_lambdas_dev, bounds[:1], side="left"))
        hi = int(torch.searchsorted(self.sorted_lambdas_dev, bounds[1:], side="right"))
        idx = self.sorted_indices_dev[lo:hi].cpu().numpy()
        lam = self.sorted_lambdas_dev[lo:hi].cpu().numpy()
        return [(int(i), float(l)) for i, l in zip(idx, lam)][:k]

    def _host_view(self) -> SortedLambdas:
        """The host copy (float64 λ, int64 ids), made at the first host
        query and kept."""
        if self._host is None:
            self._host = SortedLambdas(
                sorted_lambdas=self.sorted_lambdas_dev.cpu().numpy().astype(np.float64),
                sorted_indices=self.sorted_indices_dev.cpu().numpy().astype(np.int64),
                std_dev=self.std_dev,
            )
        return self._host

    def k_nearest_by_lambda(self, *args, **kwargs) -> list[tuple[int, float]]:
        """:meth:`SortedLambdas.k_nearest_by_lambda` on the host view."""
        return self._host_view().k_nearest_by_lambda(*args, **kwargs)

    def to_vec(self) -> list[tuple[float, int]]:
        return self._host_view().to_vec()
