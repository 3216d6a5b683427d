"""Energy pipeline with the PyTorch/CUDA port: cosine-free λ-distance
index.

Run: python examples/torch/02_energy_pipeline.py [--device cpu]
(without ``--device cpu`` it needs a CUDA card).
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def main(device=None):
    from matternet_rs_tpu_torch import ArrowSpaceBuilder, energymaps
    from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

    X = make_energy_test_dataset(1000, 48, seed=2).astype(np.float32)
    builder = (
        ArrowSpaceBuilder(device=device)
        .with_lambda_graph(1.0, 5)
        .with_cluster_params(max_clusters=24, radius=20.0)
        .with_dims_reduction(True)
        .with_sparsity_check(False)
        .with_seed(7)
    )
    aspace, gl = builder.build_energy(X)
    print(f"{aspace.sub_centroids.shape[0]} sub-centroids")

    res = energymaps.search_energy(aspace, X[3], gl, k=5)
    print("energy top-5 (ascending λ-distance):", res)
    idx, dist = energymaps.search_energy_batch(aspace, X[:4], gl, k=5)
    print("batched:", idx[:, 0].tolist())
    # Banded search: a window on the sorted-λ index instead of the full
    # corpus read; "auto" sizes the window from the λ-tie structure and
    # falls back to the full scan when banding cannot pay.
    bidx, bdist = energymaps.search_energy_batch(aspace, X[:4], gl, k=5, candidates="auto")
    print("banded :", bidx[:, 0].tolist(), f"(max λ-tie group {aspace.max_lambda_tie_group()})")
    return bdist


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="'cpu' to run without a CUDA card")
    main(parser.parse_args().device)
