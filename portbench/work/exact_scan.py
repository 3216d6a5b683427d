"""``exact_scan``: the exact tier's batch. Every row's f32-accurate dot with
every query; the rows, their norms and λ, the queries read once; the top-k
written."""

from portbench.harness.roofline import F32_ACCURATE_PASSES


def count(b: int, n: int, f: int, k: int) -> dict:
    return {"tensor_flops": F32_ACCURATE_PASSES * 2.0 * b * n * f,
            "bytes": 4.0 * n * f + 8.0 * n + 4.0 * b * f + 12.0 * b * k}


def unit(traffic: dict, cfg: dict, extra: dict) -> dict:
    return count(int(traffic["batch"]), int(cfg["shape"]["n_items"]),
                 int(cfg["shape"]["n_features"]), int(traffic["k"]))
