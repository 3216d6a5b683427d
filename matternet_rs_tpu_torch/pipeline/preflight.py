"""Stage B0: preflight — magnitude analysis, conditional L2 normalisation,
zero-variance features, variance regularisation (twin of the reference's
``pipeline/preflight.py``). One pass on the state's device; the summary
scalars come to the host."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from matternet_rs_tpu_torch.pipeline.centroid import CentroidState


@dataclasses.dataclass(frozen=True)
class PreflightConfig:
    magnitude_threshold: float = 10.0
    min_variance: float = 1e-6
    variance_epsilon: float = 1e-4
    variance_min: float = 1e-4
    variance_max: float = 100.0
    remove_zero_variance: bool = False

    @classmethod
    def conservative(cls) -> "PreflightConfig":
        return cls(magnitude_threshold=5.0, min_variance=1e-5,
                   variance_epsilon=1e-3, variance_min=1e-3, variance_max=50.0)

    @classmethod
    def strict(cls) -> "PreflightConfig":
        return cls(min_variance=1e-4, remove_zero_variance=True)


@dataclasses.dataclass
class MagnitudeStats:
    min_norm: float
    max_norm: float
    mean_norm: float
    variance_ratio: float

    def needs_normalization(self, threshold: float) -> bool:
        return self.variance_ratio > threshold


@dataclasses.dataclass
class PreflightOutput:
    normalized_centroids: torch.Tensor
    original_centroids: torch.Tensor
    variances: torch.Tensor
    was_normalized: bool
    magnitude_stats: MagnitudeStats
    zero_variance_features: np.ndarray
    state: CentroidState


class PreflightStage:
    def __init__(self, config: PreflightConfig | None = None):
        self.config = config or PreflightConfig()

    def execute(self, state: CentroidState) -> PreflightOutput:
        cfg = self.config
        means, variances = state.means, state.variances
        norms = torch.sqrt(torch.sum(means * means, dim=1))
        mn = torch.clamp(torch.min(norms), min=1e-10)
        stats_t = torch.stack([mn, torch.max(norms), torch.mean(norms)])
        ratio = stats_t[1] / stats_t[0]
        vals = torch.cat([stats_t, ratio[None]]).cpu().tolist()
        stats = MagnitudeStats(*vals)
        was_normalized = stats.needs_normalization(cfg.magnitude_threshold)
        out_means = means / torch.clamp(norms, min=1e-10)[:, None] if was_normalized else means
        feature_var = torch.mean(variances, dim=0)
        reg_var = torch.clamp(variances + cfg.variance_epsilon, cfg.variance_min, cfg.variance_max)
        zero_var = np.nonzero(feature_var.cpu().numpy() < cfg.min_variance)[0]
        return PreflightOutput(
            normalized_centroids=out_means,
            original_centroids=means,
            variances=reg_var,
            was_normalized=was_normalized,
            magnitude_stats=stats,
            zero_variance_features=zero_var,
            state=CentroidState(means=means, variances=reg_var, counts=state.counts),
        )
