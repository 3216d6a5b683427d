"""Parameter-sweep rebuilds over a device-resident corpus with the
PyTorch/CUDA port.

Rebuilding an index with different graph/λ parameters (eps/k sweeps,
radius tuning) re-runs clustering + graph + λ, but the corpus does not
change: ``build(rows, device_rows=prev.data)`` reuses the copy already on
the device instead of uploading it again.

Run: python examples/torch/10_param_sweep_rebuild.py [--device cpu]
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

    X = make_energy_test_dataset(2000, 64, seed=1).astype(np.float32)

    def builder(eps, k):
        return (
            ArrowSpaceBuilder(device=device)
            .with_lambda_graph(eps=eps, k=k)
            .with_cluster_params(max_clusters=32, radius=25.0)
            .with_sparsity_check(False)
            .with_seed(42)
        )

    # The first build uploads the corpus once.
    aspace, gl = builder(1.0, 6).build(X)
    q = X[17]
    ql = aspace.prepare_query_item(q, gl)
    base = aspace.search_lambda_aware(q, ql, 5)
    print(f"eps=1.0 k=6: top-5 {[(i, round(s, 4)) for i, s in base]}")

    # Sweep graph params; every rebuild reuses the device corpus.
    for eps, k in ((0.8, 4), (1.2, 8)):
        a2, g2 = builder(eps, k).build(X, device_rows=aspace.data)
        assert a2.data is aspace.data          # no re-upload
        ql2 = a2.prepare_query_item(q, g2)
        res = a2.search_lambda_aware(q, ql2, 5)
        print(f"eps={eps} k={k}: top-5 {[(i, round(s, 4)) for i, s in res]}")
        assert res[0][0] == 17                 # self-query still rank 1
    return np.asarray([s for _, s in base])


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="'cpu' to run without a CUDA card")
    main(parser.parse_args().device)
