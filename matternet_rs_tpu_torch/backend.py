"""Device resolution and capability report (twin of ``backend.py``).

Every entry point of the port resolves its device here: ``None`` means the
CUDA card, and with no card that is an error, never a silent CPU run. The
CPU is used only when the caller asks for it (``device="cpu"``), as the
tests do.
"""

from __future__ import annotations

import contextlib
import logging
import os
import shutil
from typing import Callable, TypeVar

import torch

log = logging.getLogger(__name__)

T = TypeVar("T")


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


def get_device(prefer: str | None = None) -> torch.device:
    """The compute device: ``None`` as :func:`resolve_device` (the card,
    raising without one); ``prefer`` ``"gpu"``/``"cuda"`` the card,
    ``"cpu"`` the CPU. ``ValueError`` when nothing matches (there is never
    a TPU)."""
    if prefer is None:
        return resolve_device(None)
    p = prefer.lower()
    if p == "cpu":
        return torch.device("cpu")
    if p in ("gpu", "cuda") and torch.cuda.is_available():
        return torch.device("cuda")
    raise ValueError(f"no device matching {prefer!r}; have {backend_info()}")


def is_tpu_available() -> bool:
    """Always False: the port runs on CUDA cards and the CPU."""
    return False


def print_backend_info() -> None:
    info = backend_info()
    log.info("backend: cuda=%s (%d devices)", info["cuda_available"], info["device_count"])
    if info["device_name"]:
        log.info("  device: %s", info["device_name"])


def dispatch(fn: Callable[[], T], prefer: str | None = None) -> T:
    """Run ``fn`` with the chosen device as torch's default device."""
    with torch.device(get_device(prefer)):
        return fn()


@contextlib.contextmanager
def on_device(prefer: str | None = None):
    """Make the chosen device torch's default device inside the block."""
    with torch.device(get_device(prefer)):
        yield
