"""Graph analytics with the PyTorch/CUDA port: motif detection, SF-GRASS
sparsification, and the LOBPCG spectral embedding.

Run: python examples/torch/07_motifs_and_embedding.py [--device cpu]
(without ``--device cpu`` it needs a CUDA card).
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def main(device=None):
    import torch

    from matternet_rs_tpu_torch import motives, sparsification
    from matternet_rs_tpu_torch.backend import resolve_device
    from matternet_rs_tpu_torch.graph import GraphParams
    from matternet_rs_tpu_torch.ops import eigensolver as eig
    from matternet_rs_tpu_torch.ops import laplacian as lap_ops
    from matternet_rs_tpu_torch.utils.fixtures import make_gaussian_cliques_multi

    dev = resolve_device(device)
    X = make_gaussian_cliques_multi(400, 0.4, 4, 16, seed=5).astype(np.float32)
    params = GraphParams(eps=0.8, k=10, topk=10, sparsity_check=False)
    gl = lap_ops.build_laplacian_matrix(torch.from_numpy(X).to(dev), params)  # item graph

    # Motifs: dense triangle neighbourhoods.
    found = motives.spot_motives_eigen(gl, motives.MotiveConfig(max_sets=6))
    print(f"{len(found)} motifs; sizes: {[len(m) for m in found]}")

    # Spectral sparsification (SF-GRASS degree-score filter).
    W = gl.adjacency().cpu().numpy()
    W_sparse = sparsification.SfGrassSparsifier(0.5).sparsify_adjacency(W)
    print(f"edges {int((W > 0).sum())} -> {int((W_sparse > 0).sum())}")

    # LOBPCG eigenmap embedding (smallest k eigenpairs of L).
    vals, vecs = eig.lobpcg_smallest(gl.matrix, 6, iters=80, seed=0)
    print("smallest eigenvalues:", np.round(np.asarray(vals), 4).tolist())
    assert vecs.shape == (400, 6)
    return np.asarray(vals)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="'cpu' to run without a CUDA card")
    main(parser.parse_args().device)
