"""Per-stage wall-clock timing with a device barrier (twin of the
reference's ``StageTimer``): on a CUDA device each stage ends with
``torch.cuda.synchronize`` so the time covers the device work, not only
its enqueue."""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Any, Iterator

import torch

log = logging.getLogger("matternet_rs_tpu_torch")


@dataclasses.dataclass
class StageTiming:
    name: str
    seconds: float
    items: int | None = None

    @property
    def items_per_sec(self) -> float | None:
        if self.items is None or self.seconds <= 0:
            return None
        return self.items / self.seconds


def _wait_for(sync: Any) -> None:
    """Wait for the streams of the CUDA tensors in ``sync`` (a tensor, or
    a list, tuple or dict of them); other values need no wait."""
    if isinstance(sync, torch.Tensor):
        if sync.is_cuda:
            torch.cuda.current_stream(sync.device).synchronize()
    elif isinstance(sync, dict):
        for v in sync.values():
            _wait_for(v)
    elif isinstance(sync, (list, tuple)):
        for v in sync:
            _wait_for(v)


class StageTimer:
    """Collects stage timings; ``device`` (a ``torch.device``) selects the
    barrier — CUDA devices are synchronised at the end of every stage."""

    def __init__(self, device: torch.device | None = None) -> None:
        self.device = device
        self.timings: list[StageTiming] = []

    @contextlib.contextmanager
    def stage(self, name: str, items: int | None = None, sync: Any = None) -> Iterator[None]:
        """Time the block. ``sync``: tensors (on the card) whose streams
        are waited for before the clock stops, as the reference's
        ``block_until_ready``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _wait_for(sync)
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.timings.append(StageTiming(name, dt, items))
            line = f"stage {name}: {dt:.3f}s"
            tput = self.timings[-1].items_per_sec
            if tput is not None:
                line += f" ({tput:,.0f} items/s)"
            log.info(line)

    def as_dict(self) -> dict[str, float]:
        return {t.name: t.seconds for t in self.timings}

    def total(self) -> float:
        return sum(t.seconds for t in self.timings)

    def report(self) -> str:
        """The stage table the reference prints, logged and returned."""
        width = 61
        lines = ["╔" + "═" * width + "╗",
                 "║ {:<{w}} ║".format("Stage timings", w=width - 2),
                 "╠" + "═" * width + "╣"]
        for t in self.timings:
            tput = f" ({t.items_per_sec:,.0f}/s)" if t.items_per_sec else ""
            lines.append("║ {:<{w}} ║".format(f"{t.name}: {t.seconds:.3f}s{tput}", w=width - 2))
        lines.append("║ {:<{w}} ║".format(f"total: {self.total():.3f}s", w=width - 2))
        lines.append("╚" + "═" * width + "╝")
        out = "\n".join(lines)
        log.info("\n%s", out)
        return out
