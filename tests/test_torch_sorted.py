"""Port vs reference: the sorted-λ index (host and device forms) and the
dense GraphLaplacian helpers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu.graph import GraphParams as JGraphParams
from matternet_rs_tpu.index.sorted import SortedLambdas as JSorted
from matternet_rs_tpu.ops import laplacian as jlap

from matternet_rs_tpu_torch.graph import GraphParams
from matternet_rs_tpu_torch.index.sorted import DeviceSortedLambdas, SortedLambdas
from matternet_rs_tpu_torch.ops import laplacian as tlap


def _lambdas():
    lam = np.random.default_rng(3).random(500).astype(np.float32)
    lam[100:110] = lam[7]                      # an equal-λ run
    return lam


def test_host_sorted_index_matches_reference():
    lam = _lambdas()
    ref, got = JSorted.build_from(lam), SortedLambdas.build_from(lam)
    assert np.array_equal(ref.sorted_indices, got.sorted_indices)   # stable ties
    assert ref.std_dev == got.std_dev
    assert ref.to_vec() == got.to_vec()
    for q, k, p in ((0.3, 12, 1.0), (float(lam[7]), 20, 3.0), (0.99, 5, 0.5)):
        assert ref.range_bylambda(q, k, p) == got.range_bylambda(q, k, p)
        assert ref.k_nearest_by_lambda(q, k, 0.1) == got.k_nearest_by_lambda(q, k, 0.1)
    ref.zadd(900, float(lam[7]))
    got.zadd(900, float(lam[7]))
    assert np.array_equal(ref.sorted_indices, got.sorted_indices)


def test_device_sorted_index_matches_host_form():
    lam = _lambdas()
    host = SortedLambdas.build_from(lam)
    dev = DeviceSortedLambdas.build_from(torch.from_numpy(lam))
    assert np.array_equal(dev.sorted_indices_dev.numpy(), host.sorted_indices)
    assert dev.std_dev == pytest.approx(host.std_dev, rel=1e-6)
    got = dev.range_bylambda(0.4, 15, 2.0)
    ref = host.range_bylambda(0.4, 15, 2.0)
    assert [i for i, _ in got] == [i for i, _ in ref]


def test_graph_laplacian_helpers_match_reference():
    X = np.random.default_rng(4).normal(size=(30, 20)).astype(np.float32)
    p = dict(eps=0.9, k=5, topk=5, sparsity_check=False)
    ref = jlap.build_laplacian_matrix(jnp.asarray(X), JGraphParams(**p))
    got = tlap.build_laplacian_matrix(torch.from_numpy(X), GraphParams(**p))
    v = np.random.default_rng(5).normal(size=30).astype(np.float32)
    assert got.shape == ref.shape and got.nnz() == ref.nnz()
    assert got.sparsity(1e-12) == pytest.approx(ref.sparsity(1e-12))
    assert np.allclose(np.asarray(ref.adjacency()), got.adjacency().numpy(), atol=1e-6)
    assert np.allclose(np.asarray(ref.degrees()), got.degrees().numpy(), atol=1e-6)
    assert np.allclose(np.asarray(ref.multiply_vector(jnp.asarray(v))),
                       got.multiply_vector(torch.from_numpy(v)).numpy(), atol=1e-5)
    assert not got.is_ell_backed
    ell, ref_ell = got.ell(), ref.ell()            # the exact ELL form, extracted once
    assert got.ell() is ell
    assert np.array_equal(np.asarray(ref_ell.indices), ell.indices.numpy())
    assert np.allclose(np.asarray(ref_ell.weights), ell.weights.numpy(), atol=1e-6)
    assert np.allclose(np.asarray(ref_ell.diag), ell.diag.numpy(), atol=1e-6)
