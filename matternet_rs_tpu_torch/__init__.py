"""PyTorch/CUDA port of ``matternet_rs_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package mirrors its module
names so each counterpart is easy to find. It imports ``torch`` and
``numpy`` only. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no explicit CPU request they raise.

Ported so far (the main path): the eigen build
(:class:`ArrowSpaceBuilder`) and the λ-aware batched search
(:meth:`ArrowSpace.search_batch`) with its exact and quantised tiers, with
hand-written CUDA kernels for the taumode λ, the fused score + sub-tile
maxima producer, the sub-tile gather, the maxima-first scan and the slab
rescore (``csrc/``). ROADMAP.md lists what waits.
"""

from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder
from matternet_rs_tpu_torch.core import (
    ArrowSpace,
    TauMode,
    UndecidableQueryError,
)
from matternet_rs_tpu_torch.graph import GraphLaplacian, GraphParams

__all__ = [
    "ArrowSpace",
    "ArrowSpaceBuilder",
    "GraphLaplacian",
    "GraphParams",
    "TauMode",
    "UndecidableQueryError",
]
