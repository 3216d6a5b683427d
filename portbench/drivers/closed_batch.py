"""``closed_batch``: one caller, closed loop. Each batch of ``batch``
held-out queries is sent when the previous one's ids are on the host; the
batches cycle through the pool (``pool_queries`` made from the seed),
starting at a batch drawn from the seed. ``warm_batches`` calls before the
window warm the cell's one shape; a traced run traces ``trace_seconds``."""

from __future__ import annotations

import time

import numpy as np

from portbench.harness import gen
from portbench.harness import trace as tr
from portbench.harness.pace import Pace
from portbench.harness.window import Window


def run(call, traffic, pool, seconds, trace, seed, device) -> Window:
    import torch

    b = int(traffic["batch"])
    n_pool = len(pool) // b
    batches = [pool[i * b:(i + 1) * b] for i in range(n_pool)]
    for i in range(int(traffic.get("warm_batches", 3))):
        call(batches[i % n_pool])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = min(seconds, float(traffic.get("trace_seconds", seconds))) if trace else seconds
    first = int(np.random.default_rng(gen.stream_seed(seed, "order")).integers(n_pool))
    tracer = tr.Tracer(trace)
    units, out_i, out_s = [], [], []
    pace = Pace()
    setup_end = time.perf_counter()
    with tracer:
        with tracer.span(tr.WINDOW):
            t0 = time.perf_counter()
            pace.start()
            while True:
                with tracer.span("pb.gen"):
                    p = (first + len(units)) % n_pool
                    Q = batches[p]
                with tracer.span("pb.entry"):
                    idx, sc = call(Q)
                pace.lap()
                units.append(p)
                out_i.append(idx)
                out_s.append(sc)
                if time.perf_counter() - t0 >= window_s:
                    break
            t1 = time.perf_counter()
    answers = [(np.arange(p * b, (p + 1) * b), i, s) for p, i, s in zip(units, out_i, out_s)]
    return Window(seconds=t1 - t0, attempted=len(units) * b,
                  completed=len(units) * b, answers=answers, setup_end=setup_end,
                  units=units, trace=tracer.reduce(), pace=pace.summary())
