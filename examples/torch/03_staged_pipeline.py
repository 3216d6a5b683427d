"""The staged pipeline with the PyTorch/CUDA port, A→B0→B1→B2→C→D
(clustering → preflight → MST → Kalman RTS → Bhattacharyya Laplacian →
spectral λ).

Run: python examples/torch/03_staged_pipeline.py [--device cpu]
(without ``--device cpu`` it needs a CUDA card).
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def main(device=None):
    from matternet_rs_tpu_torch import pipeline
    from matternet_rs_tpu_torch.utils.fixtures import make_gaussian_blob

    X = make_gaussian_blob(800, 0.5).astype(np.float32)
    result = pipeline.build(X, device=device)
    print("stage timings:", {k: round(v, 3) for k, v in result.timings.items()})
    print(f"centroids: {tuple(result.state.means.shape)}, "
          f"MST trunk length: {len(result.mst.trunk_nodes)}, "
          f"tau: {result.tau:.4f}")
    assert result.lambdas.shape == (800,)
    return result.lambdas


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="'cpu' to run without a CUDA card")
    main(parser.parse_args().device)
