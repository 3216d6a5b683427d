"""Inline samplers applied per-row during incremental clustering.

Own copy of ``matternet_rs_tpu/sampling.py`` (numpy only, so it ports bit
for bit: the same seed draws the same keep decisions in both packages).
Decisions are made on the host; they gate host-side cluster creation.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SamplerStats:
    sampled: int = 0
    discarded: int = 0


class InlineSampler:
    name = "InlineSampler"

    def __init__(self, target_rate: float, seed: int = 0):
        self.rate = float(target_rate)
        self.rng = np.random.default_rng(seed)
        self.stats = SamplerStats()

    def should_keep(
        self, nearest_dist_sq: float, centroids_count: int, max_centroids: int
    ) -> bool:
        raise NotImplementedError

    def keep_probs(
        self, nearest_dist_sq: np.ndarray, centroids_count: int, max_centroids: int
    ) -> np.ndarray:
        """Vectorized keep-probability for a batch of rows (device-batch path)."""
        raise NotImplementedError

    def decide_batch(
        self, nearest_dist_sq: np.ndarray, centroids_count: int, max_centroids: int
    ) -> np.ndarray:
        p = self.keep_probs(nearest_dist_sq, centroids_count, max_centroids)
        keep = self.rng.random(len(nearest_dist_sq)) < p
        self.stats.sampled += int(keep.sum())
        self.stats.discarded += int((~keep).sum())
        return keep

    def get_stats(self) -> tuple[int, int]:
        return self.stats.sampled, self.stats.discarded


class SimpleRandomSampler(InlineSampler):
    """Uniform keep rate (sampling.rs:108-161)."""

    name = "SimpleRandomSampler"

    def should_keep(self, nearest_dist_sq, centroids_count, max_centroids) -> bool:
        keep = self.rng.random() < self.rate
        if keep:
            self.stats.sampled += 1
        else:
            self.stats.discarded += 1
        return keep

    def keep_probs(self, nearest_dist_sq, centroids_count, max_centroids):
        return np.full(len(nearest_dist_sq), self.rate)


class DensityAdaptiveSampler(InlineSampler):
    """Rate scaled by centroid saturation and distance factor
    ``ln(d²+0.1)`` (sampling.rs:167-238)."""

    name = "DensityAdaptiveSampler"

    def _rate(self, nearest_dist_sq, centroids_count, max_centroids):
        saturation = centroids_count / max(max_centroids, 1)
        dist_factor = np.maximum(np.log(nearest_dist_sq + 0.1), 0.0)
        rate = self.rate * (1.0 - saturation * 0.1) * (1.0 + dist_factor * 0.3)
        return np.clip(rate, 0.01, 1.0)

    def should_keep(self, nearest_dist_sq, centroids_count, max_centroids) -> bool:
        rate = float(self._rate(np.float64(nearest_dist_sq), centroids_count, max_centroids))
        keep = self.rng.random() < rate
        if keep:
            self.stats.sampled += 1
        else:
            self.stats.discarded += 1
        return keep

    def keep_probs(self, nearest_dist_sq, centroids_count, max_centroids):
        return self._rate(np.asarray(nearest_dist_sq, np.float64), centroids_count, max_centroids)


def make_sampler(kind: str | None, rate: float = 1.0, seed: int = 0) -> InlineSampler:
    """``kind`` ∈ {"simple", "density_adaptive", None}. None → keep-all."""
    if kind is None:
        return SimpleRandomSampler(1.0, seed)
    if kind == "simple":
        return SimpleRandomSampler(rate, seed)
    if kind == "density_adaptive":
        return DensityAdaptiveSampler(rate, seed)
    raise ValueError(f"unknown sampler kind {kind!r}")
