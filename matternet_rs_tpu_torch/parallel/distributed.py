"""Multi-process initialisation (twin of the reference's
``parallel/distributed.py``).

One process per host (or per group of cards), every process running the
same program: after :func:`initialize`, :func:`..mesh.make_mesh` spans the
processes (each owns a contiguous run of slots) and the collectives of
:mod:`..mesh` cross them through ``torch.distributed`` — gloo for CPU
meshes, NCCL for cards. Nothing tells a program of a cluster: the caller
gives the coordinator's ``host:port``, the process count and this
process's id.
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None) -> dict:
    """Set up the process group (a no-op for one process without a
    coordinator): ``init_process_group`` at ``tcp://<coordinator_address>``
    with NCCL when the mesh is on cards (``device=None``, which needs a
    card), gloo with ``device="cpu"``. Returns the reference's four keys:
    ``process_index``, ``process_count``, ``global_device_count``,
    ``local_device_count``."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if (num_processes is not None and num_processes > 1) or coordinator_address:
        if not dist.is_initialized():
            if not cpu and not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available for an NCCL group: "
                                   "pass device='cpu' for a gloo group on the CPU")
            dist.init_process_group(
                backend="gloo" if cpu else "nccl",
                init_method=f"tcp://{coordinator_address}",
                world_size=int(num_processes or 1), rank=int(process_id or 0),
            )
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = 1 if cpu or not torch.cuda.is_available() else torch.cuda.device_count()
    info = {
        "process_index": rank,
        "process_count": world,
        "global_device_count": local * world,
        "local_device_count": local,
    }
    log.info("distributed runtime: %s", info)
    return info


def shutdown() -> None:
    """Tear the process group down (when one was set up)."""
    if dist.is_initialized():
        dist.destroy_process_group()
