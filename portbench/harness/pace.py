"""How the host kept pace in the window: the spread of the units' times,
the time lost to stalls, the rate in ten equal slices of the window, and
the process's CPU seconds. An informational line, never a metric: it says
whether a slow run was slow throughout or stood still now and then."""

from __future__ import annotations

import statistics
import time


class Pace:
    def __init__(self):
        self.laps: list = []

    def start(self) -> None:
        self.cpu0 = time.process_time()
        self.t0 = time.perf_counter()
        self.last = self.t0

    def lap(self) -> None:
        now = time.perf_counter()
        self.laps.append(now - self.last)
        self.last = now

    def summary(self) -> dict:
        if not self.laps:
            return {}
        wall = self.last - self.t0
        d = sorted(self.laps)
        med = statistics.median(d)
        q = lambda p: d[min(len(d) - 1, int(p * len(d)))]  # noqa: E731
        bins, acc = [0] * 10, 0.0
        for x in self.laps:
            acc += x
            bins[min(9, int(10 * acc / wall))] += 1
        return {"units": len(d), "median_ms": 1e3 * med, "p10_ms": 1e3 * q(0.10),
                "p90_ms": 1e3 * q(0.90), "p99_ms": 1e3 * q(0.99), "max_ms": 1e3 * d[-1],
                "stalled_s": sum(x - 3 * med for x in d if x > 3 * med),
                "units_by_tenth": bins, "wall_s": wall,
                "cpu_s": time.process_time() - self.cpu0}
