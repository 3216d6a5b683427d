"""Distributed build and search over a device mesh with the PyTorch/CUDA
port: the rows sharded over the mesh's slots, the searches merged from
each slot's top-k, and the mesh-scale spectral embedding (ring kNN +
distributed LOBPCG).

Run: python examples/torch/04_distributed.py [--device cpu]
(without ``--device cpu`` the mesh takes every visible CUDA card; with
it, 8 slots on the CPU).
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def main(device=None):
    from matternet_rs_tpu_torch.graph import GraphParams
    from matternet_rs_tpu_torch.parallel import make_mesh
    from matternet_rs_tpu_torch.parallel.index import ShardedArrowSpace
    from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

    mesh = make_mesh() if device is None else make_mesh(8, devices=[device] * 8)
    X = make_energy_test_dataset(4000, 32, seed=3).astype(np.float32)
    params = GraphParams(eps=1.0, k=6, topk=6, sparsity_check=False)

    # Per-host blocks never concatenate: each slot receives its own rows.
    sa = ShardedArrowSpace.distributed_build(
        [X[:1500], X[1500:]], params, k_clusters=16, mesh=mesh
    )
    print("serial:", sa.search(X[5], k=5)[:3])
    idx, _ = sa.search_batch(X[:4], k=5)
    print("batched top-1:", idx[:, 0].tolist())

    # Mesh-scale spectral embedding (ring-kNN graph + distributed LOBPCG).
    vals, vecs = sa.spectral_embedding(4, iters=60)
    print("smallest eigenvalues:", np.round(vals, 5).tolist())
    return vals


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="'cpu' to run without a CUDA card")
    main(parser.parse_args().device)
