"""``energy_scan``: the energy scan's batch. The λ distance of all ``b·n``
pairs (a difference, an absolute value, a comparison), and the
f32-accurate cosine of the pairs inside the tie band only, whose distinct
rows are read once; λ and norms read once. The tie band is counted by the
reference on these inputs (``tie_pairs``, ``tie_rows`` in ``extra``)."""

from portbench.harness.roofline import F32_ACCURATE_PASSES


def count(b: int, n: int, f: int, k: int, tie_pairs: float, tie_rows: float) -> dict:
    return {"tensor_flops": F32_ACCURATE_PASSES * 2.0 * tie_pairs * f,
            "cuda_flops": 3.0 * b * n,
            "bytes": 8.0 * n + 4.0 * tie_rows * f + 4.0 * b * f + 12.0 * b * k}


def unit(traffic: dict, cfg: dict, extra: dict) -> dict | None:
    if "tie_pairs" not in extra:
        return None
    return count(int(traffic["batch"]), int(cfg["shape"]["n_items"]),
                 int(cfg["shape"]["n_features"]), int(traffic["k"]),
                 extra["tie_pairs"], extra["tie_rows"])
