"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper computes with its plain version only for tensors on the CPU;
for a CUDA tensor it launches its kernel or raises. ``LAUNCHES`` counts
kernel launches per kernel: each wrapper calls :func:`count` where it
launches its kernel and nowhere else, so a run can show its path went
through the kernels. The count is taken under one lock, because serving
launches kernels from two dispatch threads at once.
"""

from __future__ import annotations

import threading

LAUNCHES: dict[str, int] = {
    "taumode": 0, "taumode_query": 0, "scores_tilemax": 0, "gather_subtiles": 0, "subtile_topk": 0,
    "tilemax_only": 0, "slab_dots": 0,
    "spmv_ell": 0, "search_fused": 0, "search_fused_merge": 0, "energy_scan": 0,
    "energy_window": 0,
}
_LOCK = threading.Lock()


def count(name: str) -> None:
    """One launch of kernel ``name``."""
    with _LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    with _LOCK:
        return dict(LAUNCHES)
