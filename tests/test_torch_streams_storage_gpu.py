"""The random streams and persistence of the port on the card. Every test
here needs a CUDA card (marker ``gpu``) and skips without one. This file
imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_streams_storage_gpu.py

Held: the projection matrix on the card bit for bit the host's
``prng.normal`` draw; ``compute_optimal_k`` on the card equal to the CPU's
(k and bounds equal, radius 1e-5 relative); the k-means++ loop and Lloyd's
iterations make no synchronising call; a checkpoint reloaded on the card
searches bit for bit as the index it was saved from, and a build with
``with_persistence`` on the card writes its artifacts.
"""

import numpy as np
import pytest
import torch

from matternet_rs_tpu_torch import clustering as tc
from matternet_rs_tpu_torch import prng
from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder
from matternet_rs_tpu_torch.reduction import ImplicitProjection
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset, make_gaussian_blob

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("seed,f,r", [(42, 768, 384), (5, 200, 100)])
def test_projection_matrix_on_the_card_is_the_host_draw(cuda_device, seed, f, r):
    m = ImplicitProjection(f, r, seed).matrix(cuda_device).cpu().numpy()
    host = prng.normal(prng.PRNGKey(seed), (f, r)) * np.float32(1.0 / np.sqrt(r))
    assert np.array_equal(m.view(np.int32), host.view(np.int32))


def test_compute_optimal_k_on_the_card_equals_the_cpu(cuda_device):
    X = make_gaussian_blob(1500, 0.4).astype(np.float32)
    k_c, r_c, id_c = tc.compute_optimal_k(X, 42, device="cpu")
    k_g, r_g, id_g = tc.compute_optimal_k(X, 42, device=cuda_device)
    assert (k_g, id_g) == (k_c, id_c)
    assert abs(r_g - r_c) <= 1e-5 * max(1.0, abs(r_c))
    init_c = tc.kmeanspp_init(torch.from_numpy(X), 13, 7)
    init_g = tc.kmeanspp_init(torch.from_numpy(X).to(cuda_device), 13, 7)
    assert torch.equal(init_g.cpu(), init_c)


def test_kmeans_steps_make_no_synchronising_call(cuda_device):
    X = torch.from_numpy(make_gaussian_blob(1000, 0.4).astype(np.float32)).to(cuda_device)
    k0, omu = tc.kmeanspp_uniforms(3, 12)
    first = int(prng.randint(k0, (), 0, X.shape[0]))
    omu_t = torch.from_numpy(omu).to(cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cents = tc.kmeanspp_steps(X, first, omu_t)
        a, c = tc.lloyd(X, cents, 20)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ra, rc = tc.kmeans_lloyd(X, 12, 20, 3)
    assert np.array_equal(a.cpu().numpy(), ra) and np.array_equal(c.cpu().numpy(), rc)


def test_checkpoint_reload_on_the_card_is_bit_identical(cuda_device, tmp_path):
    pytest.importorskip("pyarrow")
    from matternet_rs_tpu_torch.storage import parquet as tpq

    X = make_energy_test_dataset(40_000, 200, seed=7).astype(np.float32)
    b = (ArrowSpaceBuilder(device=cuda_device).with_lambda_graph(1.0, 6).with_sparsity_check(False)
         .with_cluster_params(max_clusters=40, radius=30.0).with_sampling(None)
         .with_dims_reduction(True).with_seed(42).with_persistence("hooks", tmp_path / "hooks"))
    aspace, gl = b.build(X)
    assert aspace.reduced_dim is not None
    # The builder's own persistence hooks wrote the build's artifacts.
    names = {p.name for p in (tmp_path / "hooks").iterdir()}
    assert {"hooks-raw_input.parquet", "hooks-gl-matrix.parquet", "hooks-lambdas.parquet",
            "hooks-arrowspace_metadata.json"} <= names
    assert np.array_equal(tpq.load_lambdas(tmp_path / "hooks" / "hooks-lambdas.parquet").astype(np.float32),
                          aspace.lambdas.cpu().numpy())
    Q = X[np.random.default_rng(2).choice(len(X), 64, replace=False)]
    i1, s1 = aspace.search_batch(Q, gl, 10)
    tpq.save_checkpoint(aspace, gl, b, tmp_path, "ck")
    ra, rgl = tpq.load_arrowspace(tmp_path, "ck", device="cuda")
    assert ra.device.type == "cuda"
    i2, s2 = ra.search_batch(Q, rgl, 10)
    assert np.array_equal(i1, i2) and np.array_equal(s1.view(np.int32), s2.view(np.int32))
    assert torch.equal(ra.lambdas, aspace.lambdas)
