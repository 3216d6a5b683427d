"""Readings that a cell's limits are set from, in one process over many seeds.

    python3 portbench/control.py --workloads <name> [<name> ...] --seconds <s> --seeds <n> [<n> ...]

The cells must share one configuration. For each seed: the build, each
cell's short window at its own load, and the comparison of what the
program returned with the reference (the program's readings, the lower
end of each limit); then the control, the reference computed at TF32
(each product's operands rounded to 10 mantissa bits, float32 arithmetic:
its own clustering replay, build and λ) and put in the program's place:
its state and its top-k of every pool query, judged by the same
comparison (the upper end). Also a selection fault's readings: every pool
query answered with the ids the program ranks 11th to 20th (k + 1 to 2k)
and their own scores. One JSON line per cell and seed. The
benchmark's own runs never run this. Needs a CUDA card, as ``run.py``
does; ``--device cpu`` runs it at whatever size the manifest's files say
(the tests use tiny copies)."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def one_seed(man, workloads, seed, seconds, device):
    """Records of ``workloads`` (cells of one configuration) on ``seed``:
    one build, each cell's window in turn, then the comparisons."""
    import torch

    from portbench.harness import gen
    from portbench.harness.cell import free
    from portbench.harness.manifest import Cell
    from portbench.harness.window import Window

    cells = [Cell(man, w) for w in workloads]
    if len({c.wl["config"] for c in cells}) != 1:
        raise ValueError("cells of one configuration at a time")
    cfg, mode, law = cells[0].cfg, cells[0].mode, cells[0].law
    dev = torch.device(device)
    X = gen.corpus(cfg, law, seed, dev)
    aspace, gl, _ = mode.build(cfg, X)
    del X
    pools, wins, faults = [], [], []
    for c in cells:
        pools.append(gen.query_pool(cfg, law, int(c.traffic["pool_queries"]), seed, dev))
        wins.append(c.driver.run(c.entry.make(aspace, gl, c.traffic), c.traffic, pools[-1],
                                 seconds, False, seed, dev))
        faults.append(_ranks_after_k(c, aspace, gl, pools[-1]))
    state = mode.state(cfg, aspace, gl)
    del aspace, gl
    free(dev)
    X = gen.corpus(cfg, law, seed, dev)
    ref = mode.reference(cfg, X, state)
    ctrl = mode.reference(cfg, X, None, "tf32")
    cstate = mode.reference_state(ctrl)
    out = []
    for c, pool, win, fwin in zip(cells, pools, wins, faults):
        program, _ = mode.judge(cfg, c.traffic, ref, state, pool, win)
        cwin = Window(seconds=0.0, attempted=len(pool), completed=len(pool),
                      answers=mode.answers(ctrl, c.traffic, pool), setup_end=0.0)
        control, _ = mode.judge(cfg, c.traffic, ref, cstate, pool, cwin)
        fault, _ = mode.judge(cfg, c.traffic, ref, state, pool, fwin)
        out.append({"workload": c.name, "seed": seed, "program": program, "control": control,
                    "fault_ranks_k1_2k": fault})
    return out


def _ranks_after_k(cell, aspace, gl, pool):
    """A window in which every pool query is answered with the ids the
    program ranks k + 1 to 2k, with their own scores."""
    from portbench.harness.window import Window

    k, b = int(cell.traffic["k"]), int(cell.traffic["batch"])
    call = cell.entry.make(aspace, gl, dict(cell.traffic, k=2 * k))
    answers = []
    for q0 in range(0, len(pool) - b + 1, b):
        idx, sc = call(pool[q0:q0 + b])[:2]
        answers.append((np.arange(q0, q0 + b), np.asarray(idx)[:, k:], np.asarray(sc)[:, k:]))
    return Window(seconds=0.0, attempted=len(pool), completed=len(pool),
                  answers=answers, setup_end=0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness.manifest import Manifest

    if args.device == "cuda" and not torch.cuda.is_available():
        print("portbench control: needs a CUDA card", file=sys.stderr)
        return 2
    man = Manifest(Path(args.root))
    for seed in args.seeds:
        for rec in one_seed(man, args.workloads, seed, args.seconds, args.device):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
