"""PyTorch/CUDA port of ``matternet_rs_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package mirrors its module
names so each counterpart is easy to find. It imports ``torch`` and
``numpy`` only. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no explicit CPU request they raise.

Ported so far: the eigen build (:class:`ArrowSpaceBuilder`, with the
optimal-k heuristics, the JL projection and Parquet persistence) and the
λ-aware batched search (:meth:`ArrowSpace.search_batch`) with its exact and
quantised tiers; ``jax.random``'s threefry stream (:mod:`.prng`); the
Parquet checkpoints and the single-host shard store (:mod:`.storage`,
which alone imports ``pyarrow``); the large-F sparse path (ELL graphs and
their direct build, sparse λ beyond 2048 features, the LOBPCG
eigensolver); the energy pipeline and energy-mode search
(:mod:`.energymaps`), motifs, subgraphs and sparsification; item
mutation and append, the λ-band, hybrid, sorted, range and IVF searches
(:mod:`.index.ivf`); the staged pipeline (:mod:`.pipeline`); and a
hand-written CUDA kernel for every TPU kernel of the reference — the
taumode λ, the fused score + sub-tile maxima producer, the sub-tile gather,
the maxima-first scan, the slab rescore, the ELL sparse product and the
streamed exact top-k (``csrc/``). ROADMAP.md lists the modules that wait.
"""

from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder
from matternet_rs_tpu_torch.core import (
    TAU_FLOOR,
    ArrowSpace,
    TauMode,
    UndecidableQueryError,
)
from matternet_rs_tpu_torch.graph import GraphLaplacian, GraphParams
from matternet_rs_tpu_torch.ops.csr import EllLaplacian, SparseGraph
from matternet_rs_tpu_torch.ops.eigensolver import lobpcg_smallest, spectral_embedding
from matternet_rs_tpu_torch.ops.kernels.search_fused import search_fused
from matternet_rs_tpu_torch import backend, eigenmaps

__version__ = "0.2.0"


def init(level: int | str = "INFO") -> None:
    """One-time logging set-up, as the reference's ``init``: the root
    logger at ``level`` with a time, level and logger name on each line."""
    import logging

    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )


__all__ = [
    "TAU_FLOOR",
    "__version__",
    "ArrowSpace",
    "ArrowSpaceBuilder",
    "EllLaplacian",
    "GraphLaplacian",
    "GraphParams",
    "SparseGraph",
    "TauMode",
    "UndecidableQueryError",
    "backend",
    "eigenmaps",
    "init",
    "lobpcg_smallest",
    "search_fused",
    "spectral_embedding",
]
