"""HTTP serving with the PyTorch/CUDA port: micro-batched concurrent
dispatch.

Run: python examples/torch/06_serving.py [--device cpu]
(without ``--device cpu`` it needs a CUDA card). From the shell the same
service starts with ``python -m matternet_rs_tpu_torch serve <checkpoint>``.
"""
import argparse
import json
import os
import sys
import urllib.request

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def main(device=None):
    from matternet_rs_tpu_torch import ArrowSpaceBuilder
    from matternet_rs_tpu_torch.serve import IndexService, serve
    from matternet_rs_tpu_torch.utils.fixtures import make_gaussian_blob

    X = make_gaussian_blob(500, 0.4).astype(np.float32)
    aspace, gl = (
        ArrowSpaceBuilder(device=device)
        .with_lambda_graph(1.0, 6)
        .with_cluster_params(max_clusters=16, radius=6.0)
        .with_sparsity_check(False)
        .build(X)
    )
    service = IndexService(aspace, gl)
    server = serve(service, port=0, block=False)
    port = server.server_address[1]
    try:
        body = json.dumps({"query": X[9].tolist(), "k": 3}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/search", data=body,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req) as resp:
            doc = json.loads(resp.read())
        print("HTTP top-3:", doc["results"])
        assert doc["results"][0]["index"] == 9
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    return np.asarray([r["score"] for r in doc["results"]])


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="'cpu' to run without a CUDA card")
    main(parser.parse_args().device)
