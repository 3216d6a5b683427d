"""The mesh layer on the card: 4 slots placed on one card (a device listed
four times), each slot launching the kernels with its own rows. Every
test needs a CUDA card and ``nvcc`` (marker ``gpu``) and skips without
them. This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_parallel_gpu.py

Checks: the exact batch over 4 slots of 98,304 rows launches kernel B and
the candidate stage once a slot and equals the single-card search (the
near-tie rule, 1e-5), and kernel C once a slot at k = 40;
``bf16x3_rescored`` launches kernels D and E once a
slot and returns exact scores; kernel F's rows form equals its plain
version bit for bit, and distributed LOBPCG launches it once a slot per
operator application; a mesh of more cards than the machine has raises.
"""

import numpy as np
import pytest
import torch

from matternet_rs_tpu_torch import backend
from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops import search as so
from matternet_rs_tpu_torch.ops.kernels import spmv_ell as fk
from matternet_rs_tpu_torch.parallel import knn_graph as tkg
from matternet_rs_tpu_torch.parallel import make_mesh, shard_items
from matternet_rs_tpu_torch.parallel.index import ShardedArrowSpace
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset
from matternet_rs_tpu_torch.utils.parity import topk_mismatches

pytestmark = pytest.mark.gpu

# 98,304 rows a slot: at k = 40 the selection keeps 44 of 48 tiles (at
# 20 tiles a slot every k > 16 would be degenerate and take the flat route).
N, F, B, K, D = 4 * 98_304 - 3, 128, 256, 10, 4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if backend.nvcc_path() is None:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def index(card):
    from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder

    data = make_energy_test_dataset(N, F, seed=44).astype(np.float32)
    aspace, gl = (ArrowSpaceBuilder().with_lambda_graph(1.0, 6).with_sparsity_check(False)
                  .with_cluster_params(max_clusters=64, radius=25.0).with_sampling(None)
                  .build(data))
    sa = ShardedArrowSpace.from_arrowspace(aspace, gl, mesh=make_mesh(D, devices=[card] * D))
    rows = np.random.default_rng(5).choice(N, B, replace=False)
    return data, aspace, gl, sa, rows


def _launched(fn):
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


def test_exact_batch_launches_b_and_the_stage_per_slot(index):
    data, aspace, gl, sa, rows = index
    sa.search_batch(data[rows], K)                       # warm-up
    (gi, gs), counts = _launched(lambda: sa.search_batch(data[rows], K))
    assert counts["scores_tilemax"] == D and counts["subtile_topk"] == D
    assert counts["gather_subtiles"] == 0
    ri, rs = aspace.search_batch(data[rows], gl, K + 1)
    assert not topk_mismatches(ri, rs, gi, gs, 1e-5)
    (_, _), counts = _launched(lambda: sa.search_batch(data[rows], 40))     # the wide stage
    assert counts["subtile_topk"] == D and counts["gather_subtiles"] == 0


@pytest.mark.parametrize("tier", ["bf16x3_rescored", "int8_rescored"])
def test_rescored_tiers_launch_d_and_e_per_slot(index, tier):
    data, aspace, gl, sa, rows = index
    sa.search_batch(data[rows], K, quantized=tier)
    (gi, gs), counts = _launched(lambda: sa.search_batch(data[rows], K, quantized=tier))
    assert counts["tilemax_only"] == D and counts["slab_dots"] == D
    Q = torch.from_numpy(data[rows]).cuda()
    ql = sa.prepare_query_lambdas_batch(Q)
    X = aspace.data
    exact = so._batched_scores(X, aspace.norms, aspace.lambdas, Q, ql, 0.7)
    got = torch.gather(exact, 1, torch.from_numpy(gi).cuda()).cpu().numpy()
    np.testing.assert_allclose(gs, got, atol=1e-5, rtol=0)


@pytest.mark.parametrize("row0,n,m", [(0, 1000, 15), (1000, 999, 1), (40, 5000, 33)])
def test_spmv_ell_rows_kernel_is_bit_for_bit(card, row0, n, m):
    nx = 6000
    g = torch.Generator().manual_seed(row0 + m)
    idx = torch.randint(-1, nx, (nx, 12), generator=g, dtype=torch.int32)
    w = torch.rand((nx, 12), generator=g) * (idx >= 0)
    d = torch.rand(nx, generator=g)
    V = torch.randn((nx, m), generator=g)
    args = [t[row0:row0 + n].to(card) for t in (idx, w)]
    got, counts = _launched(lambda: fk.spmv_ell(*args, V.to(card), d[row0:row0 + n].to(card),
                                                row0))
    assert counts["spmv_ell"] == 1
    ref = fk.spmv_ell_plain(idx[row0:row0 + n], w[row0:row0 + n], V, d[row0:row0 + n], row0)
    assert torch.equal(got.cpu(), ref)


def test_lobpcg_launches_kernel_f_per_slot(card):
    n = 4000
    X = make_energy_test_dataset(n, 32, seed=7).astype(np.float32)
    mesh = make_mesh(D, devices=[card] * D)
    ell = tkg.distributed_knn_ell_laplacian(mesh, shard_items(mesh, X), n,
                                            GraphParams(eps=1.0, k=6, topk=6, sparsity_check=False),
                                            reverse_k="auto")
    assert ell.dropped_reverse_edges == 0
    iters = 20
    (vals, vecs, res), counts = _launched(
        lambda: tkg.distributed_lobpcg(mesh, ell, 4, iters=iters, return_residuals=True))
    assert counts["spmv_ell"] == D * (iters + 2)
    assert np.all(np.isfinite(vals)) and vecs.shape == (n, 4)
    assert np.all(np.diff(vals) >= -1e-5) and vals[0] > -1e-3


def test_more_cards_than_the_machine_has_raise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {have + 1} devices, only {have} available"):
        make_mesh(have + 1)
