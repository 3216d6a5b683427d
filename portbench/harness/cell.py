"""One run of one cell: set-up, the measured window, the comparison with
the reference, the metrics, the result line."""

from __future__ import annotations

import gc
import json
import sys
import time

import torch

from portbench.harness import check, gen
from portbench.harness.manifest import Cell, Manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "matternet_rs_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def info(tag: str, **fields) -> None:
    """An informational line on standard output (never the last one)."""
    print(json.dumps({"info": tag, **fields}, default=float), flush=True)


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, root=None) -> dict:
    t_start = time.perf_counter() if t_start is None else t_start
    man = Manifest() if root is None else Manifest(root)
    c = Cell(man, workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    X = gen.corpus(c.cfg, c.law, seed, dev)
    pool = gen.query_pool(c.cfg, c.law, int(c.traffic["pool_queries"]), seed, dev)
    aspace, gl, stages = c.mode.build(c.cfg, X)
    del X
    info("build_stages", seconds=stages)
    if trace:
        from matternet_rs_tpu_torch.ops import kernels
        kernels.reset_launches()

    call = c.entry.make(aspace, gl, c.traffic)
    win = c.driver.run(call, c.traffic, pool, seconds, trace, seed, dev)
    setup_s = win.setup_end - t_start
    if win.pace:
        info("pace", **win.pace)
    if trace:
        info("launches", counts=kernels.launch_counts(), units=len(win.units))
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0

    # The program's state is kept, the program freed; then the reference.
    state = c.mode.state(c.cfg, aspace, gl)
    del aspace, gl, call
    free(dev)
    t_ref = time.perf_counter()
    ref = c.mode.reference(c.cfg, gen.corpus(c.cfg, c.law, seed, dev), state)
    readings, extra = c.mode.judge(c.cfg, c.traffic, ref, state, pool, win)
    del ref
    info("reference", seconds=time.perf_counter() - t_ref, readings=readings, **extra)
    correct, checks = check.verdict(readings, c.traffic["limits"])

    # Metrics: end to end with --trace 0, per layer with --trace 1.
    tr = win.trace or {}
    ctx = {"setup_s": setup_s, "window": win, "readings": readings,
           "units": len(win.units),
           "work": c.work.unit(c.traffic, c.cfg, extra) if c.work else None,
           "busy_s": tr.get("busy_s"), "window_s": tr.get("window_s")}
    metrics = {}
    for m in man.metrics_of(workload, "per_layer" if trace else "end_to_end"):
        v = man.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    if trace:
        device_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    out = {"correct": correct, "attempted": win.attempted,
           "failed": win.attempted - win.completed, "metrics": metrics, "device": device_info}
    if trace:
        out["breakdown"] = tr["breakdown"]
    out["checks"] = checks
    return out
