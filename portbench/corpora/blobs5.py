"""``blobs5``: the law of the repository's ``make_energy_test_dataset``.
Five separated clusters in row order (cluster ``c`` at ``(10c, 10(c % 2))``
in the first two coordinates), uniform ±0.8 noise in every coordinate, the
remainder of ``n`` over 5 uniform ±1."""

from __future__ import annotations

import torch

N_CLUSTERS = 5


def rows(n: int, f: int, gen: torch.Generator, device) -> torch.Tensor:
    """``[n, f]`` float32 rows of the law, drawn by ``gen`` on ``device``."""
    per = n // N_CLUSTERS
    out = torch.rand((n, f), generator=gen, device=device, dtype=torch.float32)
    out.mul_(2.0).sub_(1.0)
    cid = torch.arange(N_CLUSTERS, device=device, dtype=torch.float32)
    body = out[:per * N_CLUSTERS].view(N_CLUSTERS, per, f)
    body.mul_(0.8)
    body[:, :, 0] += (cid * 10.0)[:, None]
    body[:, :, 1] += ((cid % 2) * 10.0)[:, None]
    return out
