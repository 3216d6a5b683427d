"""``rescored_scan``: a maxima-first tier's batch. The exact tier's scan
plus the f32-accurate dots of the ``work_cand`` selected slabs of
``work_slab_rows`` rows per query (their rows are already counted once by
the scan)."""

from portbench.harness.roofline import F32_ACCURATE_PASSES
from portbench.work import exact_scan


def count(b: int, n: int, f: int, k: int, cand: int, slab_rows: int) -> dict:
    w = exact_scan.count(b, n, f, k)
    w["tensor_flops"] += F32_ACCURATE_PASSES * 2.0 * b * cand * slab_rows * f
    return w


def unit(traffic: dict, cfg: dict, extra: dict) -> dict:
    return count(int(traffic["batch"]), int(cfg["shape"]["n_items"]),
                 int(cfg["shape"]["n_features"]), int(traffic["k"]),
                 int(traffic["work_cand"]), int(traffic["work_slab_rows"]))
