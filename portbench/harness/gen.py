"""Inputs from ``--seed``: the corpus and the query pool, each from a
stream of its own, drawn on the device by a ``torch.Generator`` in a few
large calls by the configuration's law (``corpora/<law>.py``). The queries
are rows of the same law from another stream, shuffled, so they are not
corpus rows and each batch mixes the law's parts."""

from __future__ import annotations

import zlib

import numpy as np
import torch


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` of ``seed`` (any whole number)."""
    ss = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), int(seed) >> 64,
                                 zlib.crc32(stream.encode())])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def _generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def corpus(cfg: dict, law, seed: int, device) -> torch.Tensor:
    """``[N, F]`` float32 corpus rows on ``device``; ``law`` is the
    configuration's ``corpora/<law>.py`` module."""
    shape = cfg["shape"]
    return law.rows(int(shape["n_items"]), int(shape["n_features"]),
                    _generator(seed, "corpus", device), device)


def query_pool(cfg: dict, law, n_queries: int, seed: int, device) -> np.ndarray:
    """``[n_queries, F]`` float32 held-out queries, shuffled, on the host."""
    g = _generator(seed, "queries", device)
    q = law.rows(n_queries, int(cfg["shape"]["n_features"]), g, device)
    perm = torch.randperm(n_queries, generator=g, device=device)
    return q[perm].cpu().numpy()
