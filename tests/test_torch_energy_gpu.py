"""Energy mode on the card: an energy index built on the card serves
``search_batch`` through the kernels (the exact tier: kernel B and the
candidate stage; ``bf16x3_rescored``: kernels D and E), held against the
same routes through the kernels' plain versions, and the energy scan
against the same index on the CPU. Every test needs a CUDA card and
``nvcc`` (marker ``gpu``) and skips without them. This file imports no
JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_energy_gpu.py

Tolerances: the exact tier under the near-tie rule at 1e-5
(``utils/parity.topk_mismatches``), the rescored tier under the same-k
rule at 1e-5; the energy scan on the card against the CPU's under the
same-k rule at 1e-14 (the tie-break term ``1e-9·(1 − cos)`` at a cosine
tolerance of 1e-5).
"""

import numpy as np
import pytest
import torch

from matternet_rs_tpu_torch import backend, convert
from matternet_rs_tpu_torch import energymaps as tem
from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder
from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops import search as tso
from matternet_rs_tpu_torch.ops.kernels import rescored as trsk
from matternet_rs_tpu_torch.ops.kernels import tilemax as ttmk
from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset
from matternet_rs_tpu_torch.utils.parity import ENERGY_TIE_TOL, same_k_mismatches, topk_mismatches

pytestmark = pytest.mark.gpu

N, F, B, K = 65_536, 128, 256, 10


@pytest.fixture(scope="module")
def energy_index():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if backend.nvcc_path() is None:
        pytest.skip("needs nvcc to build the kernels")
    data = make_energy_test_dataset(N, F, seed=43).astype(np.float32)
    b = (ArrowSpaceBuilder().with_lambda_graph(1.0, 6).with_sparsity_check(False)
         .with_cluster_params(max_clusters=64, radius=25.0).with_sampling(None)
         .with_expected_items(N).with_dims_reduction(True))
    aspace, gl = b.build_energy(data)
    Q = data[np.random.default_rng(3).choice(N, B, replace=False)]
    return data, aspace, gl, Q


def _batch(aspace, Q):
    dev = aspace.device
    Qt = torch.from_numpy(Q).to(dev)
    ql = aspace._nearest_subcentroid_lambdas(aspace._energy_query(Qt))
    return Qt, ql, torch.full((len(Q),), 0.7, dtype=torch.float32, device=dev)


def test_energy_exact_tier_runs_kernel_b_and_the_stage(energy_index):
    _, aspace, gl, Q = energy_index
    kernels.reset_launches()
    idx, sc, raw = aspace.search_batch(Q, gl, K, return_raw=True)
    counts = kernels.launch_counts()
    assert counts["scores_tilemax"] == 1 and counts["subtile_topk"] == 1, counts
    Qt, ql, al = _batch(aspace, Q)
    assert np.array_equal(raw, ql.cpu().numpy())
    top_p, idx_p = tso.fused_tilemax(
        aspace.data, aspace.norms, aspace.lambdas, Qt, ql, K + 1, al, tso.DEFAULT_TILE,
        producer=ttmk.scores_and_tilemax_plain, gather=ttmk.gather_subtiles_plain,
        select=ttmk.select_topk_plain)
    assert not topk_mismatches(idx_p.cpu().numpy(), top_p.cpu().numpy(), idx, sc, 1e-5)


def test_energy_bf16x3_tier_runs_kernels_d_and_e(energy_index):
    _, aspace, gl, Q = energy_index
    kernels.reset_launches()
    idx, sc = aspace.search_batch(Q, gl, K, quantized="bf16x3_rescored")
    counts = kernels.launch_counts()
    assert counts["tilemax_only"] == 1 and counts["slab_dots"] == 1, counts
    Qt, ql, al = _batch(aspace, Q)
    X = aspace.data
    pidx, ptop = tso.fused_scan_rescored(
        X, X, aspace.norms, aspace.lambdas, Qt, ql, K, aspace._int8_cand(K, None), al,
        producer=trsk.tilemax_only_plain, slab_reader=trsk.slab_dots_plain)
    assert not same_k_mismatches(pidx.cpu().numpy(), ptop.cpu().numpy(), idx, sc, 1e-5)


@pytest.mark.parametrize("candidates", [None, "auto", 2000])
def test_energy_scan_on_the_card_matches_the_cpu(energy_index, candidates):
    _, aspace, gl, Q = energy_index
    p = aspace.projection
    ca, cg = convert.arrowspace_from_arrays(
        aspace.data.cpu().numpy(), aspace.lambdas.cpu().numpy(), gl.matrix.cpu().numpy(),
        min_lambdas=aspace.min_lambdas, max_lambdas=aspace.max_lambdas,
        range_lambdas=aspace.range_lambdas,
        projection=None if p is None else (p.original_dim, p.reduced_dim, p.seed),
        sub_centroids=aspace.sub_centroids.cpu().numpy(),
        subcentroid_lambdas=aspace.subcentroid_lambdas, centroid_map=aspace.centroid_map,
        item_norms=aspace.item_norms.cpu().numpy(), device="cpu")
    Qs = Q[:32]
    gi, gd = tem.search_energy_batch(aspace, Qs, gl, K, candidates=candidates)
    ri, rd = tem.search_energy_batch(ca, Qs, cg, K, candidates=candidates)
    assert not same_k_mismatches(ri, rd, gi, gd, ENERGY_TIE_TOL)


def test_argmin_and_argmax_take_the_first_index_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    big = torch.zeros(3, 70_000, device="cuda")
    big[:, 5] = big[:, 40_000] = -1.0
    assert torch.argmin(big, dim=1).tolist() == [5, 5, 5]
    assert torch.argmax(-big, dim=1).tolist() == [5, 5, 5]
    assert torch.argmin(torch.zeros(2, 300, device="cuda"), dim=1).tolist() == [0, 0]
