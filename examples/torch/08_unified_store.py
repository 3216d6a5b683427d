"""One on-disk index, three consumers, with the PyTorch/CUDA port: the
distributed resume, the single-device out-of-core search and the CLI all
read the same directory.

Run: python examples/torch/08_unified_store.py [--device cpu]
(without ``--device cpu`` the mesh takes every visible CUDA card; with
it, 8 slots on the CPU).
"""
import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def main(device=None):
    from matternet_rs_tpu_torch.graph import GraphParams
    from matternet_rs_tpu_torch.index.streaming import StreamingIndex
    from matternet_rs_tpu_torch.parallel import make_mesh
    from matternet_rs_tpu_torch.parallel.index import ShardedArrowSpace
    from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

    X = make_energy_test_dataset(3000, 24, seed=8).astype(np.float32)
    params = GraphParams(eps=1.0, k=6, topk=6, sparsity_check=False)

    def mesh():
        return make_mesh() if device is None else make_mesh(8, devices=[device] * 8)

    with tempfile.TemporaryDirectory() as store:
        # Build on the mesh, persist once.
        sa = ShardedArrowSpace.distributed_build(
            [X[:1200], X[1200:]], params, k_clusters=16, mesh=mesh()
        )
        sa.to_store(store)
        print("persisted:", sorted(os.listdir(store))[:4], "...")

        # Consumer 1: the distributed resume (nothing recomputed).
        r1 = ShardedArrowSpace.load_from_store(store, mesh=mesh()).search(X[5], k=3)
        # Consumer 2: one device, the corpus staying on disk.
        r2 = StreamingIndex.load(store, device=device).search(X[5], k=3)
        # Consumer 3: python -m matternet_rs_tpu_torch search-streaming <store>.
        print("distributed:", r1)
        print("streamed:   ", r2)
        assert [i for i, _ in r1] == [i for i, _ in r2]
        return np.array([s for _, s in r1])


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="'cpu' to run without a CUDA card")
    main(parser.parse_args().device)
