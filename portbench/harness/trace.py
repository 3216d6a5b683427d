"""The traced window: ``torch.profiler`` over it, reduced to the device's
busy time (the union of the device operations' intervals), the window's
length, the device operations that took most time, and the longest idle
gaps labelled by the benchmark's own host-side range active at the time
(``pb.*`` ranges around the entry, whose return carries the result's fetch,
the generator and, served, each dispatch)."""

from __future__ import annotations

import bisect
import contextlib
import time

from portbench.harness.stats import merge_spans

WINDOW = "pb.window"
TOP = 10


class Tracer:
    """One run's traced window, or nothing when ``on`` is false. The
    profiler records the ranges of the thread that started it only, so each
    range is also kept here on the host clock, from any thread, and placed
    on the trace's timeline by the window's own range."""

    def __init__(self, on: bool):
        self.on = on
        self.ranges: list = []        # (start_us, end_us, name), host clock
        self.prof = None
        if on:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)

    def __enter__(self):
        if self.prof is not None:
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        from torch.profiler import record_function

        t0 = time.perf_counter()
        try:
            with record_function(name):
                yield
        finally:
            self.ranges.append((t0 * 1e6, time.perf_counter() * 1e6, name))

    def _events(self):
        """``(device_spans, window)``: device operations as ``(start_us,
        end_us, name)`` and the trace's ``pb.window`` range, from the
        profiler's raw events (the ``prof.events()`` tree takes minutes on a
        window's worth). The device's copies of the host's ranges are
        annotations, not operations."""
        from torch.autograd import DeviceType

        dev, window = [], None
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            s, t = e.start_ns() / 1e3, e.end_ns() / 1e3
            if e.device_type() == DeviceType.CUDA:
                if not name.startswith("pb.") and not e.is_user_annotation():
                    dev.append((s, t, name))
            elif name == WINDOW and window is None:
                window = (s, t)
        return dev, window

    def reduce(self) -> dict | None:
        """``busy_s``, ``window_s`` and the ``breakdown`` of the window."""
        if not self.on:
            return None
        dev, window = self._events()
        ours = [r for r in self.ranges if r[2] == WINDOW]
        if window is None or not ours:
            raise RuntimeError("the trace holds no pb.window range")
        w0, w1 = window
        shift = w0 - ours[-1][0]           # host clock → trace timeline
        host = sorted((s + shift, t + shift, n) for s, t, n in self.ranges if n != WINDOW)
        clipped = [(max(s, w0), min(t, w1), n) for s, t, n in dev if t > w0 and s < w1]
        merged = merge_spans([(s, t) for s, t, _ in clipped])

        by_op: dict[str, float] = {}
        for s, t, n in clipped:
            by_op[n] = by_op.get(n, 0.0) + (t - s)
        device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]

        # Idle gaps, each labelled by the innermost range covering its midpoint.
        starts = [r[0] for r in host]
        gaps, cur = [], w0
        for s, t in merged:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, t)
        if w1 > cur:
            gaps.append((cur, w1))
        idle: dict[str, float] = {}
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            label, best = "host.outside_ranges", None
            i = bisect.bisect_right(starts, mid)
            for j in range(i - 1, max(i - 64, -1), -1):
                s, t, n = host[j]
                if s <= mid <= t and (best is None or t - s < best):
                    label, best = n, t - s
            idle[label] = idle.get(label, 0.0) + (g1 - g0)
        idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {
            "busy_s": sum(t - s for s, t in merged) / 1e6,
            "window_s": (w1 - w0) / 1e6,
            "breakdown": {
                "device_ops": [[n[:120], v / 1e6] for n, v in device_ops],
                "idle_gaps": [[n, v / 1e6] for n, v in idle_gaps],
            },
        }
