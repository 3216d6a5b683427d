"""Per-stage wall-clock timing with a device barrier (twin of the
reference's ``utils/profiling.py``): on a CUDA device each stage ends with
``torch.cuda.synchronize`` so the time covers the device work, not only
its enqueue. ``device_trace`` writes a ``torch.profiler`` trace where the
reference writes a ``jax.profiler`` one.

Spans inside a call (:func:`span`): on exactly while a ``torch.profiler``
session records, in any thread. Each span is kept in a bounded ring on
the ``time.perf_counter_ns`` clock (:func:`spans`) and entered as a
profiler event of the same name, so it also shows on the trace's timeline
beside the kernels it launched. Each place where the host waits
for the card goes through :func:`to_device`, :func:`to_host` or
:func:`count_sync`, which count one sync against the innermost open span."""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import logging
import threading
import time
from typing import Any, Iterator, NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

log = logging.getLogger("matternet_rs_tpu_torch")

SPAN_RING = 65_536
# The profiler event of a span: ``torch.profiler.record_function``'s C++
# core. ``record_function`` itself calls two dispatcher operators, which
# the profiler records as events of their own: ≈ 10× the cost, and tens of
# µs between its timestamps and the span's.
_record_function = torch._C._profiler._RecordFunctionFast


class SpanRecord(NamedTuple):
    """One finished span: ``start_ns``/``end_ns`` on ``time.perf_counter_ns``,
    its ``parent`` span's id (None for a root), the ``root`` id shared by
    every span of one tree, the ``thread`` (``threading.get_ident``), the
    host–device ``syncs`` counted while it was the innermost span, and its
    ``attrs``."""

    name: str
    id: int
    parent: int | None
    root: int
    thread: int
    start_ns: int
    end_ns: int
    syncs: int
    attrs: dict


_spans: collections.deque = collections.deque(maxlen=SPAN_RING)
_open = threading.local()              # .stack: this thread's open spans, innermost last
_ids = itertools.count(1)


class _NoSpan:
    """What :func:`span` returns while no profiler records: nothing to do."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "root", "syncs", "start_ns", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.syncs = name, attrs, 0

    def set(self, **attrs) -> None:
        """Add attributes known only once the span has started."""
        self.attrs.update(attrs)

    def __enter__(self):
        try:
            stack = _open.stack
        except AttributeError:
            stack = _open.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[-1].root if stack else self.id
        self._rf = _record_function(self.name)
        self._rf.__enter__()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        # Both stamps follow the event's own: its start is taken as it is
        # entered, its end late in its exit.
        _open.stack.pop()
        self._rf.__exit__(*exc)
        end_ns = time.perf_counter_ns()
        _spans.append(SpanRecord(self.name, self.id, self.parent, self.root,
                                 threading.get_ident(), self.start_ns, end_ns, self.syncs,
                                 self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager that records the block as a span while a
    ``torch.profiler`` session records (a profiler event and the ring),
    else a shared no-op. Spans opened inside it, in the same thread, are its
    children. ``.set(**attrs)`` adds attributes later."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, attrs)


def spans() -> list[SpanRecord]:
    """The finished spans in the ring (the newest ``SPAN_RING``), oldest
    first; a copy."""
    return list(_spans)


def clear_spans() -> None:
    _spans.clear()


def count_sync(device) -> None:
    """Count one host–device sync against this thread's innermost open
    span when ``device`` is not the host: a call beside a site that waits
    for the card (``float()``, ``.item()`` or ``.tolist()`` of a device
    tensor, a tensor made on the device from host values, a synchronise)."""
    if _autograd_profiler._is_profiler_enabled and torch.device(device).type != "cpu":
        stack = getattr(_open, "stack", None)
        if stack:
            stack[-1].syncs += 1


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t.to(device)``, counted as one sync when it copies host memory to
    a device (a blocking copy)."""
    if t.device.type == "cpu":
        count_sync(device)
    return t.to(device)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``, counted as one sync when ``t`` is on a device."""
    count_sync(t.device)
    return t.cpu()


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


@contextlib.contextmanager
def device_trace(log_dir) -> Iterator[None]:
    """``torch.profiler`` trace of the block (CPU, and the card when there
    is one), written under ``log_dir`` as a Chrome trace
    (``trace.json``; open it in Perfetto or ``chrome://tracing``)."""
    import pathlib

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


def timed_block_until_ready(x, name: str = "op") -> float:
    """Wait for ``x`` (a tensor, or a list, tuple or dict of them) and log
    the wait: each CUDA tensor's device stream is synchronised, a CPU
    tensor needs no wait. Returns the seconds waited."""
    t0 = time.perf_counter()
    _wait_for(x)
    dt = time.perf_counter() - t0
    log.info("%s ready in %.3fs", name, dt)
    return dt


def lambda_statistics(lambdas) -> dict:
    """λ distribution statistics (a tensor or an array), in float64."""
    import numpy as np

    if isinstance(lambdas, torch.Tensor):
        lambdas = lambdas.detach().cpu().numpy()
    lam = np.asarray(lambdas, np.float64)
    return {
        "min": float(lam.min()),
        "max": float(lam.max()),
        "mean": float(lam.mean()),
        "std": float(lam.std()),
        "range": float(lam.max() - lam.min()),
        "count": int(lam.size),
    }
