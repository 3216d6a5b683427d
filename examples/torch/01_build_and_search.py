"""Eigen pipeline with the PyTorch/CUDA port: build a λ-aware index and
query it.

Run: python examples/torch/01_build_and_search.py [--device cpu]
(without ``--device cpu`` it needs a CUDA card).
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def main(device=None):
    from matternet_rs_tpu_torch import ArrowSpaceBuilder, eigenmaps
    from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

    X = make_energy_test_dataset(2000, 64, seed=1).astype(np.float32)

    builder = (
        ArrowSpaceBuilder(device=device)
        .with_lambda_graph(eps=1.0, k=6)
        .with_cluster_params(max_clusters=32, radius=25.0)
        .with_sparsity_check(False)
        .with_seed(42)
    )
    aspace, gl = builder.build(X)

    # Single query (blended cosine + λ-proximity score).
    results = eigenmaps.search(aspace, X[17], gl, k=5, alpha=0.7)
    print("top-5:", results)
    assert results[0][0] == 17

    # Batched path: one scan for the whole batch.
    idx, scores = aspace.search_batch(X[:8], gl, k=5, approx=True)
    print("batched top-1 ids:", idx[:, 0].tolist())
    return scores


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="'cpu' to run without a CUDA card")
    main(parser.parse_args().device)
