"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper computes with its plain version only for tensors on the CPU;
for a CUDA tensor it launches its kernel or raises. ``LAUNCHES`` counts
kernel launches per kernel, incremented where each kernel is launched and
nowhere else, so a run can show its path went through the kernels.
"""

from __future__ import annotations

LAUNCHES: dict[str, int] = {
    "taumode": 0, "scores_tilemax": 0, "gather_subtiles": 0,
    "tilemax_only": 0, "slab_dots": 0,
    "spmv_ell": 0, "search_fused": 0, "search_fused_merge": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)
