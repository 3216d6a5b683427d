"""CentroidState: ``[C, F]`` means, diagonal variances and counts, on one
device (twin of the reference's ``pipeline/centroid.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from matternet_rs_tpu_torch.backend import resolve_device


@dataclasses.dataclass
class CentroidState:
    means: torch.Tensor        # [C, F]
    variances: torch.Tensor    # [C, F] diagonal covariance
    counts: torch.Tensor       # [C] int32

    @classmethod
    def from_clustering(cls, centroids, counts, initial_variance: float = 0.1,
                        device=None) -> "CentroidState":
        """A uniform initial variance, refined later by stage B2.
        ``device``: where the state lives (``None`` is the CUDA card)."""
        dev = resolve_device(device)
        means = torch.from_numpy(np.array(centroids, np.float32)).to(dev)
        return cls(means=means,
                   variances=torch.full(means.shape, initial_variance, dtype=torch.float32,
                                        device=dev),
                   counts=torch.from_numpy(np.array(counts, np.int32)).to(dev))

    @property
    def num_centroids(self) -> int:
        return int(self.means.shape[0])

    @property
    def feature_dim(self) -> int:
        return int(self.means.shape[1])

    def get_thickness(self) -> torch.Tensor:
        """Mean variance per centroid, trace(P)/F."""
        return torch.mean(self.variances, dim=1)

    def to_feature_nodes(self) -> torch.Tensor:
        """The ``[F, C]`` feature profiles."""
        return self.means.T

    def get_feature_variances(self) -> torch.Tensor:
        return self.variances.T

    def regularize_variances(self, eps: float, min_var: float, max_var: float) -> "CentroidState":
        """A new state with ``clamp(var + eps, min_var, max_var)``."""
        return CentroidState(means=self.means,
                             variances=torch.clamp(self.variances + eps, min_var, max_var),
                             counts=self.counts)
