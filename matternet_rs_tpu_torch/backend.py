"""Device resolution and capability report (twin of ``backend.py``).

Every entry point of the port resolves its device here: ``None`` means the
CUDA card, and with no card that is an error, never a silent CPU run. The
CPU is used only when the caller asks for it (``device="cpu"``), as the
tests do.
"""

from __future__ import annotations

import os
import shutil

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); otherwise as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' to run the "
                "port on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is available")
    return dev


def nvcc_path() -> str | None:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    cands = [
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def backend_info() -> dict:
    """CUDA present, card name and count, nvcc present, library versions."""
    cuda = torch.cuda.is_available()
    return {
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "nvcc": nvcc_path(),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
    }
