"""Out-of-core index with the PyTorch/CUDA port: the corpus on disk, the
exact search streaming blocks through one device, the resident int8
sketch with an exact disk rescore, and the sketch sharded over a mesh.

Run: python examples/torch/05_out_of_core.py [--device cpu]
(without ``--device cpu`` it needs a CUDA card).
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
    from matternet_rs_tpu_torch.parallel import ShardedSketch, make_mesh
    from matternet_rs_tpu_torch.storage import shards
    from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

    X = make_energy_test_dataset(5000, 32, seed=4).astype(np.float32)
    params = GraphParams(eps=1.0, k=6, topk=6, sparsity_check=False)

    with tempfile.TemporaryDirectory() as store:
        shards.write_shards(X, store, rows_per_shard=1024)
        si = StreamingIndex.build_from_store(
            store, params, max_clusters=24, radius=25.0, block_rows=1024, device=device,
        )
        print("top-5:", si.search(X[11], k=5))
        # Reload without recompute; bf16 blocks halve the upload bytes.
        si2 = StreamingIndex.load(store, device=device)
        print("resumed top-1:", si2.search(X[11], k=1, quantized=True))

        # The serving path: the resident int8 sketch (one upload) and an
        # exact disk rescore; refine=False skips the rescore.
        si2.build_sketch(persist=False)
        print("sketch top-3:", si2.search_sketch(X[11], k=3))
        print("sketch-only top-3:", si2.search_sketch(X[11], k=3, refine=False))

        # A sketch bigger than one card shards over a mesh: the same scan
        # per slot, one merge, the same results.
        mesh = make_mesh() if device is None else make_mesh(4, devices=[device] * 4)
        sk = ShardedSketch(si2, mesh)
        res = sk.search(X[11], k=3)
        print("mesh-sharded top-3:", res)
        assert [i for i, _ in res] == [i for i, _ in si2.search_sketch(X[11], k=3)]
        return np.array([s for _, s in res])


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="'cpu' to run without a CUDA card")
    main(parser.parse_args().device)
