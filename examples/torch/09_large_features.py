"""Large feature dimensions with the PyTorch/CUDA port: the direct-ELL
graph path (F >= 8192).

Beyond ``DIRECT_ELL_N`` graph nodes, ``build_laplacian_matrix`` switches to
a construction that never forms the [F, F] matrix: tiled exact kNN (one
[row_tile, F] distance strip at a time) feeding a fixed-degree ELL
Laplacian. λ scoring and the eigensolver consume the ELL form directly; on
the card the eigensolver's operator is the hand-written ELL product.

Run: python examples/torch/09_large_features.py [--device cpu]
(shown at a forced-small size so it runs in seconds; the production route
engages automatically at F >= 8192. Without ``--device cpu`` it needs a
CUDA card.)
"""
import argparse
import os
import sys

import numpy as np


def main(device=None):
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    from matternet_rs_tpu_torch import GraphParams
    from matternet_rs_tpu_torch.backend import resolve_device
    from matternet_rs_tpu_torch.ops import laplacian as lap_ops
    from matternet_rs_tpu_torch.ops import taumode as tm_ops
    from matternet_rs_tpu_torch.ops.eigensolver import lobpcg_smallest

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    F, C, N = 2048, 96, 4000          # F plays the "huge" role
    centroids = rng.normal(size=(C, F)).astype(np.float32)
    params = GraphParams(eps=1.0, k=6, topk=6, sparsity_check=False)

    # Direct ELL build over the feature profiles (graph nodes = features).
    gl = lap_ops.build_laplacian_ell(torch.from_numpy(centroids.T.copy()).to(dev), params, n_items=N)
    assert gl.is_ell_backed
    e = gl.ell()
    print(f"graph: {gl.shape}, ELL memory {e.nbytes() / 1e6:.1f} MB "
          f"(dense would be {F * F * 4 / 1e6:.0f} MB)")

    # λ scoring consumes the ELL operator directly.
    X = torch.from_numpy(rng.normal(size=(256, F)).astype(np.float32)).to(dev)
    lam = tm_ops.taumode_lambdas_auto(X, e, tm_ops.TAU_MEDIAN).cpu().numpy()
    assert lam.shape == (256,) and np.all(np.isfinite(lam))
    print("λ[:4] =", np.round(lam[:4], 5))

    # Spectral embedding through the same sparse operator (no dense L).
    vals, vecs = lobpcg_smallest(e, k=4, iters=40)
    print("smallest eigenvalues:", np.round(vals, 5))
    assert vecs.shape == (F, 4)

    print("ok")
    return vals


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="'cpu' to run without a CUDA card")
    main(parser.parse_args().device)
