"""The quantised tier ladder with the PyTorch/CUDA port: scan speed
against candidate recall, one knob.

Every tier returns exact scores (each returned row is rescored in full
f32 from the corpus); the tiers trade only candidate recall for scan
speed. ``quantized="auto"`` picks a tier from ``recall_target`` by the
reference's measured ladder (PERF.md records how the tiers measure on the
H100).

Run: python examples/torch/11_quantized_tiers.py [--device cpu]
(without ``--device cpu`` it needs a CUDA card).
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def main(device=None):
    from matternet_rs_tpu_torch import ArrowSpaceBuilder
    from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

    X = make_energy_test_dataset(4000, 64, seed=3).astype(np.float32)
    builder = (
        ArrowSpaceBuilder(device=device)
        .with_lambda_graph(eps=1.0, k=6)
        .with_cluster_params(max_clusters=32, radius=25.0)
        .with_sparsity_check(False)
        .with_seed(42)
    )
    aspace, gl = builder.build(X)
    Q = X[:16]

    # Exact reference ranking.
    idx_exact, sc_exact = aspace.search_batch(Q, gl, k=10)

    # Named tiers: same call, one string.
    for tier in ("bf16x3_rescored", "int8_rescored", "int8"):
        idx, sc = aspace.search_batch(Q, gl, k=10, quantized=tier)
        overlap = np.mean([
            len(set(idx[i].tolist()) & set(idx_exact[i].tolist())) / 10
            for i in range(len(Q))
        ])
        print(f"{tier:16s} top-1 ids {idx[:4, 0].tolist()}  overlap@10 vs exact {overlap:.3f}")
        assert (idx[:, 0] == np.arange(len(Q))).all()

    # Recall-target routing: say what you need, not which kernel.
    for target in (0.999, 0.95, 0.8):
        idx, _ = aspace.search_batch(Q, gl, k=10, quantized="auto", recall_target=target)
        assert (idx[:, 0] == np.arange(len(Q))).all()
        print(f"auto(recall_target={target}) ok")

    # The dominated bf16_rescored rung is gated behind an explicit override.
    try:
        aspace.search_batch(Q, gl, k=10, quantized="bf16_rescored")
    except ValueError as e:
        print("bf16_rescored gated:", str(e)[:60], "...")

    # candidates=N makes a tier reproduce the exact search.
    idx_full, sc_full = aspace.search_batch(Q, gl, k=10, quantized="int8_rescored", candidates=len(X))
    np.testing.assert_array_equal(idx_full, idx_exact)
    print("candidates=N escape hatch: equal to exact")
    return sc_full


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="'cpu' to run without a CUDA card")
    main(parser.parse_args().device)
