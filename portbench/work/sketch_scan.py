"""``sketch_scan``: the refined sketch tier's batch. The int8 codes read
once (``N·F`` bytes) with their multipliers and λ (``8N``); every code's
product with every query at the bf16 tensor rate in one pass (int8 is
exact in bf16, the sketch's own precision); one pass of products over the
``work_slabs`` selected slabs of ``work_slab_rows`` rows per query; the
refine's f32-accurate products of each query with its ``candidates``
rows (three bf16 passes); the queries read and the top-k written."""

from portbench.harness.roofline import F32_ACCURATE_PASSES


def count(b: int, n: int, f: int, k: int, cand: int, slabs: int, slab_rows: int) -> dict:
    return {"tensor_flops": 2.0 * b * n * f + 2.0 * b * slabs * slab_rows * f
            + F32_ACCURATE_PASSES * 2.0 * b * cand * f,
            "bytes": 1.0 * n * f + 8.0 * n + 4.0 * b * f + 12.0 * b * k}


def unit(traffic: dict, cfg: dict, extra: dict) -> dict:
    return count(int(traffic["batch"]), int(cfg["shape"]["n_items"]),
                 int(cfg["shape"]["n_features"]), int(traffic["k"]), int(traffic["candidates"]),
                 int(traffic["work_slabs"]), int(traffic["work_slab_rows"]))
