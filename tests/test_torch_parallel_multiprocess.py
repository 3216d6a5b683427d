"""The mesh across processes: two OS processes, each with 4 CPU slots,
form one gloo process group (``parallel.distributed.initialize``) and run
the distributed build, the searches, the ring-kNN spectral embedding and
the store build over the global 8-slot mesh (and a 2 × 4 mesh whose slice
axis crosses the process boundary). Every process passes the same global
blocks and places only its own slots. The results must agree across the
processes, with the one-process 8-slot build, and with the reference's
8-device build (ids equal, scores within 1e-6).
"""

import json
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

WORKER = textwrap.dedent("""
import json, sys
sys.path.insert(0, sys.argv[4])
pid, port, store = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import numpy as np
from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.parallel import distributed, make_mesh, make_mesh_2d
from matternet_rs_tpu_torch.parallel.index import ShardedArrowSpace
from matternet_rs_tpu_torch.storage import shards
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

info = distributed.initialize(f"127.0.0.1:{port}", 2, pid, device="cpu")
data = make_energy_test_dataset(800, 16, seed=77).astype(np.float32)
params = GraphParams(eps=1.0, k=5, topk=5, sparsity_check=False)
mesh = make_mesh(8, devices=["cpu"] * 4)
sa = ShardedArrowSpace.distributed_build([data[:300], data[300:]], params, k_clusters=10,
                                         mesh=mesh)
out = {"info": info, "local": list(mesh.local_slots),
       "search": sa.search(data[17], k=5)}
sa2 = ShardedArrowSpace.distributed_build([data[:300], data[300:]], params, k_clusters=10,
                                          mesh=make_mesh_2d(2, 4, devices=["cpu"] * 4))
out["search2d"] = sa2.search(data[17], k=5)
vals, _ = sa.spectral_embedding(4, iters=60, reverse_k=40)
out["eig"] = vals.tolist()
bidx, bsc = sa.search_batch(data[[4, 9]], k=3)
out["batch"] = [bidx.tolist(), bsc.tolist()]
out["quantized"] = sa.search_batch(data[[4, 9]], k=3, quantized="int8_rescored")[0].tolist()
out["hybrid"] = sa.search_hybrid(data[17], k=3)
out["energy"] = sa.search_energy(data[17], k=3)
sa3 = shards.distributed_build_from_store(store, params, k_clusters=10, mesh=make_mesh(8, devices=["cpu"] * 4))
out["store"] = sa3.search(data[17], k=3)
print("RESULT " + json.dumps(out), flush=True)
distributed.shutdown()
""")

DATA_SEED, N = 77, 800


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one_process(store):
    from matternet_rs_tpu_torch.graph import GraphParams
    from matternet_rs_tpu_torch.parallel import make_mesh, make_mesh_2d
    from matternet_rs_tpu_torch.parallel.index import ShardedArrowSpace
    from matternet_rs_tpu_torch.storage import shards
    from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

    cpu8 = ["cpu"] * 8
    data = make_energy_test_dataset(N, 16, seed=DATA_SEED).astype(np.float32)
    params = GraphParams(eps=1.0, k=5, topk=5, sparsity_check=False)
    sa = ShardedArrowSpace.distributed_build([data[:300], data[300:]], params, k_clusters=10,
                                             mesh=make_mesh(8, devices=cpu8))
    sa2 = ShardedArrowSpace.distributed_build([data[:300], data[300:]], params, k_clusters=10,
                                              mesh=make_mesh_2d(2, 4, devices=cpu8))
    bidx, bsc = sa.search_batch(data[[4, 9]], k=3)
    return {
        "search": sa.search(data[17], k=5), "search2d": sa2.search(data[17], k=5),
        "eig": sa.spectral_embedding(4, iters=60, reverse_k=40)[0].tolist(),
        "batch": [bidx.tolist(), bsc.tolist()],
        "quantized": sa.search_batch(data[[4, 9]], k=3, quantized="int8_rescored")[0].tolist(),
        "hybrid": sa.search_hybrid(data[17], k=3), "energy": sa.search_energy(data[17], k=3),
        "store": shards.distributed_build_from_store(store, params, k_clusters=10,
                                                     mesh=make_mesh(8, devices=cpu8)).search(
            data[17], k=3),
    }


def _as_lists(res):
    return json.loads(json.dumps(res))


def test_two_gloo_processes_match_one_process_and_the_reference(tmp_path):
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_gloo_available():
        pytest.fail("torch.distributed with gloo is required")
    from matternet_rs_tpu_torch.storage import shards
    from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

    data = make_energy_test_dataset(N, 16, seed=DATA_SEED).astype(np.float32)
    store = tmp_path / "store"
    shards.write_shards(data, store, rows_per_shard=250)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), port, str(store), str(REPO)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    res = [json.loads(next(line for line in out.splitlines()
                           if line.startswith("RESULT "))[7:]) for out in outs]
    assert res[0]["info"] == {"process_index": 0, "process_count": 2,
                              "global_device_count": 2, "local_device_count": 1}
    assert res[0]["local"] == [0, 1, 2, 3] and res[1]["local"] == [4, 5, 6, 7]
    for key in ("search", "search2d", "eig", "batch", "quantized", "hybrid", "energy", "store"):
        assert res[1][key] == res[0][key], key
    one = _as_lists(_one_process(store))
    for key in one:
        assert res[0][key] == one[key], key

    # The reference's one-process build on its 8 devices.
    from matternet_rs_tpu.graph import GraphParams as JGraphParams
    from matternet_rs_tpu.parallel import make_mesh as jmake_mesh
    from matternet_rs_tpu.parallel.index import ShardedArrowSpace as JSA

    js = JSA.distributed_build([data[:300], data[300:]],
                               JGraphParams(eps=1.0, k=5, topk=5, sparsity_check=False),
                               k_clusters=10, mesh=jmake_mesh(8))
    ref = js.search(data[17], k=5)
    assert [i for i, _ in res[0]["search"]] == [i for i, _ in ref]
    np.testing.assert_allclose([s for _, s in res[0]["search"]], [s for _, s in ref], atol=1e-6)
    rb = js.search_batch(data[[4, 9]], k=3)
    assert res[0]["batch"][0] == np.asarray(rb[0]).tolist()
    assert torch.distributed.is_initialized() is False
