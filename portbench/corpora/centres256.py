"""``centres256``: a mixture of 256 Gaussian centres of scale 4 with unit
Gaussian noise, each row's centre drawn uniformly, so the rows come in
random order. The centres belong to the law (drawn once, from the law's
own seed, on the device asked for), so the corpus and the held-out
queries, each from its own stream, are samples of one mixture; the rows'
centres and noise come from ``gen``."""

from __future__ import annotations

import torch

N_CENTRES = 256
CENTRE_SCALE = 4.0
CENTRE_SEED = 256
CHUNK = 1 << 22                     # rows given their centre at a time


def centres(f: int, device) -> torch.Tensor:
    """``[256, f]`` float32 centres of the law on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(CENTRE_SEED)
    return CENTRE_SCALE * torch.randn((N_CENTRES, f), generator=g, device=device)


def rows(n: int, f: int, gen: torch.Generator, device) -> torch.Tensor:
    """``[n, f]`` float32 rows of the law, drawn by ``gen`` on ``device``."""
    c = centres(f, device)
    label = torch.randint(0, N_CENTRES, (n,), generator=gen, device=device)
    out = torch.randn((n, f), generator=gen, device=device, dtype=torch.float32)
    for s in range(0, n, CHUNK):
        out[s:s + CHUNK] += c[label[s:s + CHUNK]]
    return out
