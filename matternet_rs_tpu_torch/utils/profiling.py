"""Per-stage wall-clock timing with a device barrier (twin of the
reference's ``StageTimer``): on a CUDA device each stage ends with
``torch.cuda.synchronize`` so the time covers the device work, not only
its enqueue."""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Iterator

import torch

log = logging.getLogger("matternet_rs_tpu_torch")


@dataclasses.dataclass
class StageTiming:
    name: str
    seconds: float
    items: int | None = None


class StageTimer:
    """Collects stage timings; ``device`` (a ``torch.device``) selects the
    barrier — CUDA devices are synchronised at the end of every stage."""

    def __init__(self, device: torch.device | None = None) -> None:
        self.device = device
        self.timings: list[StageTiming] = []

    @contextlib.contextmanager
    def stage(self, name: str, items: int | None = None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.timings.append(StageTiming(name, dt, items))
            log.info("stage %s: %.3fs", name, dt)

    def as_dict(self) -> dict[str, float]:
        return {t.name: t.seconds for t in self.timings}
