"""Port vs reference: the distributed searches of ``parallel/search.py``.

Both packages get the same numpy rows, norms and λ, sharded over 8 slots
(the reference's 8 CPU devices; the port's 8 CPU slots), as a 1-D mesh
and as a 2 × 4 ``(slice, data)`` mesh. At these sizes every slot takes
the flat route in both packages (kernel B's fused route starts at 32,768
rows a slot: the last test holds the port's per-slot kernel routes against
its single-card search at that size).

Tolerances: ids equal; scores within 1e-6 relative (the same f32
products, summed by XLA and by PyTorch). Rows 3 and 11 are real all-zero
rows (ranked by their λ term); padded rows must never come back with a
finite score.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu.core import _quantize_rows_device_jit
from matternet_rs_tpu.parallel import mesh as jmesh
from matternet_rs_tpu.parallel import search as jps

from matternet_rs_tpu_torch.ops import search as tso
from matternet_rs_tpu_torch.parallel import mesh as tmesh
from matternet_rs_tpu_torch.parallel import search as tps
from matternet_rs_tpu_torch.parallel.index import ShardedArrowSpace
from matternet_rs_tpu_torch.utils.parity import topk_mismatches

CPU = torch.device("cpu")
RTOL = 1e-6


def _meshes(kind):
    if kind == "1d":
        return jmesh.make_mesh(8), tmesh.make_mesh(8, devices=[CPU] * 8)
    return jmesh.make_mesh_2d(2, 4), tmesh.make_mesh_2d(2, 4, devices=[CPU] * 8)


def _data(n, f=16, b=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[3] = 0.0
    if n > 11:
        X[11] = 0.0
    norms = np.sqrt(np.sum(X * X, axis=1)).astype(np.float32)
    lams = rng.random(n, dtype=np.float32)
    Q = rng.normal(size=(b, f)).astype(np.float32)
    ql = rng.random(b, dtype=np.float32)
    return X, norms, lams, Q, ql


def _both(kind, n, seed=0):
    jm, tm = _meshes(kind)
    X, norms, lams, Q, ql = _data(n, seed=seed)
    jarr = [jmesh.shard_items(jm, jnp.asarray(a)) for a in (X, norms, lams)]
    tarr = [tmesh.shard_items(tm, a) for a in (X, norms, lams)]
    return jm, tm, jarr, tarr, Q, ql


def _same(ref_i, ref_s, got_i, got_s, n):
    ref_i, ref_s = np.asarray(ref_i), np.asarray(ref_s)
    got_i, got_s = got_i.numpy(), got_s.numpy()
    assert got_i.shape == ref_i.shape
    assert np.array_equal(got_i, ref_i)
    fin = np.isfinite(ref_s)
    assert np.array_equal(np.isfinite(got_s), fin)
    np.testing.assert_allclose(got_s[fin], ref_s[fin], rtol=RTOL, atol=1e-7)
    assert np.all(got_i[np.isfinite(got_s)] < n)          # no padded id is ranked


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("n,k", [(1001, 10), (30, 12), (30, 31), (8, 3)])
def test_single_query_search(kind, n, k):
    jm, tm, jarr, tarr, Q, ql = _both(kind, n, seed=n + k)
    if kind == "1d":
        jfn, tfn = jps.make_sharded_search(jm, n, k), tps.make_sharded_search(tm, n, k)
    else:
        jfn, tfn = jps.make_multislice_search(jm, n, k), tps.make_multislice_search(tm, n, k)
    for b in range(3):
        ri, rs = jfn(*jarr, jnp.asarray(Q[b]), jnp.float32(ql[b]), jnp.float32(0.7))
        gi, gs = tfn(*tarr, Q[b], float(ql[b]), 0.7)
        _same(ri, rs, gi, gs, n)


def test_zero_rows_are_ranked_by_lambda():
    """A real all-zero row scores (1 − α)·λ-sim, so a query whose λ equals
    it finds it; the padding is masked by id, not by norm."""
    jm, tm, jarr, tarr, Q, ql = _both("1d", 30, seed=5)
    lam3 = float(tarr[2].gather()[3])
    gi, gs = tps.make_sharded_search(tm, 30, 30)(*tarr, np.zeros(16, np.float32), lam3, 0.0)
    assert gi[0].item() == 3 and gs[0].item() == pytest.approx(1.0)
    ri, rs = jps.make_sharded_search(jm, 30, 30)(*jarr, jnp.zeros(16), jnp.float32(lam3),
                                                 jnp.float32(0.0))
    _same(ri, rs, gi, gs, 30)


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("n,k", [(1001, 10), (30, 31)])
def test_energy_search(kind, n, k):
    jm, tm, jarr, tarr, Q, ql = _both(kind, n, seed=7)
    jfn, tfn = jps.make_sharded_energy_search(jm, n, k), tps.make_sharded_energy_search(tm, n, k)
    for b in range(3):
        ri, rs = jfn(*jarr, jnp.asarray(Q[b]), jnp.float32(ql[b]))
        gi, gs = tfn(*tarr, Q[b], float(ql[b]))
        _same(ri, rs, gi, gs, n)


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("n,k", [(1001, 10), (30, 12), (30, 40)])
def test_batched_exact_search(kind, n, k):
    jm, tm, jarr, tarr, Q, ql = _both(kind, n, seed=11)
    ri, rs = jps.make_sharded_search_batch(jm, n, k)(*jarr, jnp.asarray(Q), jnp.asarray(ql),
                                                     jnp.float32(0.6))
    gi, gs = tps.make_sharded_search_batch(tm, n, k)(*tarr, torch.from_numpy(Q),
                                                     torch.from_numpy(ql), 0.6)
    _same(ri, rs, gi, gs, n)


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("tier", ["int8", "int8_rescored", "bf16x3_rescored"])
@pytest.mark.parametrize("n,k,cand", [(1001, 10, 64), (30, 12, 4)])
def test_batched_quantized_search(kind, tier, n, k, cand):
    jm, tm, jarr, tarr, Q, ql = _both(kind, n, seed=13)
    b = 8
    rng = np.random.default_rng(3)
    Q = rng.normal(size=(b, 16)).astype(np.float32)
    ql = rng.random(b, dtype=np.float32)
    al = rng.uniform(0.3, 0.9, b).astype(np.float32)
    jfn = jps.make_sharded_search_batch_quantized(jm, n, k, cand, tier)
    tfn = tps.make_sharded_search_batch_quantized(tm, n, k, cand, tier)
    if tier == "bf16x3_rescored":
        ri, rs = jfn(*jarr, jnp.asarray(Q), jnp.asarray(ql), jnp.asarray(al))
        gi, gs = tfn(*tarr, torch.from_numpy(Q), torch.from_numpy(ql), torch.from_numpy(al))
    else:
        X8j, mj = _quantize_rows_device_jit(jarr[0])
        sa = ShardedArrowSpace(mesh=tm, X=tarr[0], norms=tarr[1], lambdas=tarr[2], gl=None,
                               n_items=n)
        X8t, mt = sa._ensure_int8()
        assert np.array_equal(X8t.gather().numpy(), np.asarray(X8j))
        ri, rs = jfn(jarr[0], X8j, mj, jarr[1], jarr[2], jnp.asarray(Q), jnp.asarray(ql),
                     jnp.asarray(al))
        gi, gs = tfn(tarr[0], X8t, mt, tarr[1], tarr[2], torch.from_numpy(Q),
                     torch.from_numpy(ql), torch.from_numpy(al))
    _same(ri, rs, gi, gs, n)


def test_quantized_tier_name_is_checked():
    tm = tmesh.make_mesh(2, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="sharded quantized tier"):
        tps.make_sharded_search_batch_quantized(tm, 10, 3, 8, "bf16_rescored")


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("n,k", [(1001, 10), (30, 12)])
def test_hybrid_search(kind, n, k):
    jm, tm, jarr, tarr, Q, ql = _both(kind, n, seed=17)
    # A near-duplicate of a row: its cosine clears the semantic threshold.
    q = tarr[0].gather()[n // 2].numpy() * 1.0000001
    jfn, tfn = jps.make_sharded_hybrid_search(jm, n, k), tps.make_sharded_hybrid_search(tm, n, k)
    for qq, lq in ((q, 0.2), (Q[0], float(ql[0])), (Q[1], float(ql[1]))):
        ri, rs = jfn(*jarr, jnp.asarray(qq), jnp.float32(lq), jnp.float32(0.7))
        gi, gs = tfn(*tarr, qq, lq, 0.7)
        _same(ri, rs, gi, gs, n)


def test_sharded_search_lambda_aware_masks_given_n_items():
    jm, tm, jarr, tarr, Q, ql = _both("1d", 30, seed=19)
    ri, rs = jps.sharded_search_lambda_aware(jm, *jarr, Q[0], float(ql[0]), 31, n_items=30)
    gi, gs = tps.sharded_search_lambda_aware(tm, *tarr, Q[0], float(ql[0]), 31, n_items=30)
    _same(ri, rs, gi, gs, 30)


@pytest.mark.parametrize("tier", [False, "bf16x3_rescored", "int8_rescored"])
def test_per_slot_kernel_routes_match_the_single_card_search(tier, monkeypatch):
    """At 33,266 rows a slot (2 slots) each slot takes the single-card
    kernel route — kernel B and the candidate stage with ``mask_from``, or
    kernels D and E — through the kernels' plain versions here; the merged
    result equals the single-card search of the whole corpus (the near-tie
    rule of ``utils/parity.py`` for ids, scores within 1e-6 relative)."""
    n, f, b, k = 2 * 33_266 - 1, 16, 8, 10
    per = 33_266
    rng = np.random.default_rng(23)
    X = rng.normal(size=(n, f)).astype(np.float32)
    norms = np.sqrt(np.sum(X * X, axis=1)).astype(np.float32)
    lams = rng.random(n, dtype=np.float32)
    Q = X[rng.choice(n, b, replace=False)] + 0.01
    ql = rng.random(b, dtype=np.float32)
    tm = tmesh.make_mesh(2, devices=[CPU] * 2)
    arrs = [tmesh.shard_items(tm, a) for a in (X, norms, lams)]
    Qt, qlt = torch.from_numpy(Q), torch.from_numpy(ql)
    routed = []
    for name in ("fused_tilemax", "fused_scan_rescored"):
        real = getattr(tso, name)
        monkeypatch.setattr(tso, name, lambda *a, _r=real, _n=name, **kw: (
            routed.append((_n, kw.get("mask_from"))), _r(*a, **kw))[1])
    if tier is False:
        gi, gs = tps.make_sharded_search_batch(tm, n, k)(*arrs, Qt, qlt, 0.7)
        assert routed == [("fused_tilemax", per), ("fused_tilemax", n - per)]
        ri, rs = tso.search_lambda_aware_tilemax(torch.from_numpy(X), torch.from_numpy(norms),
                                                 torch.from_numpy(lams), Qt, qlt, k + 1, 0.7)
        assert not topk_mismatches(ri.numpy(), rs.numpy(), gi.numpy(), gs.numpy(), 1e-5)
        return
    sa = ShardedArrowSpace(mesh=tm, X=arrs[0], norms=arrs[1], lambdas=arrs[2], gl=None,
                           n_items=n)
    al = torch.full((b,), 0.7)
    fn = tps.make_sharded_search_batch_quantized(tm, n, k, 64, tier)
    if tier == "int8_rescored":
        gi, gs = fn(arrs[0], *sa._ensure_int8(), *arrs[1:], Qt, qlt, al)
    else:
        gi, gs = fn(*arrs, Qt, qlt, al)
    assert routed == [("fused_scan_rescored", per), ("fused_scan_rescored", n - per)]
    # Every returned score is the exact blended score of its id.
    Xt = torch.from_numpy(X)
    exact = tso._batched_scores(Xt, torch.from_numpy(norms), torch.from_numpy(lams), Qt, qlt, 0.7)
    np.testing.assert_allclose(gs.numpy(), torch.gather(exact, 1, gi).numpy(), rtol=RTOL,
                               atol=1e-7)
    assert np.all(gi.numpy() < n)
