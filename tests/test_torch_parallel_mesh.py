"""Port vs reference: the mesh, sharded placement and the collectives.

The reference runs on its 8 virtual CPU devices (``tests/conftest.py``),
the port on 8 slots of the CPU (a device listed 8 times, the port's
counterpart of XLA's host device count). Placement is compared bit for
bit: each slot's shard against the reference device's addressable shard
of the same global rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matternet_rs_tpu.parallel import mesh as jmesh

from matternet_rs_tpu_torch.parallel import mesh as tmesh
from matternet_rs_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

CPU = torch.device("cpu")


def _meshes(kind):
    if kind == "1d":
        return jmesh.make_mesh(8), make_mesh(8, devices=[CPU] * 8)
    return jmesh.make_mesh_2d(2, 4), make_mesh_2d(2, 4, devices=[CPU] * 8)


def _reference_shards(arr):
    """The reference array's device shards in global row order."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start or 0)
    return [np.asarray(s.data) for s in shards]


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("n", [37, 40, 3])
def test_shard_items_per_slot_equals_reference(kind, n):
    jm, tm = _meshes(kind)
    x = np.random.default_rng(n).normal(size=(n, 5)).astype(np.float32)
    ref = _reference_shards(jmesh.shard_items(jm, jnp.asarray(x)))
    got = tmesh.shard_items(tm, x)
    assert got.shape == (tmesh.pad_to_mesh(n, tm), 5) == (jmesh.pad_to_mesh(n, jm), 5)
    assert len(ref) == len(got.shards) == 8
    for r, (slot, t) in zip(ref, got.local()):
        assert t.device == CPU and np.array_equal(t.numpy(), r), slot
    # Padding rows are zero, after the real rows.
    assert np.all(got.gather().numpy()[n:] == 0.0)
    assert np.array_equal(got.gather().numpy()[:n], x)


def test_two_d_slot_order_is_row_major():
    jm, tm = _meshes("2d")
    assert tm.shape == dict(jm.shape) == {"slice": 2, "data": 4}
    assert tm.axis_names == tuple(jm.axis_names)
    # A slot's global rows follow (slice, data) row-major, as the
    # reference's flat_axis_index.
    x = np.arange(16, dtype=np.float32)[:, None]
    got = tmesh.shard_items(tm, x)
    for s in range(2):
        for d in range(4):
            assert got.shards[s * 4 + d][0, 0].item() == 2 * (s * 4 + d)


@pytest.mark.parametrize("sizes", [[300, 501], [7], [5, 0, 9, 13]])
def test_shard_items_from_blocks_equals_reference(sizes, monkeypatch):
    rng = np.random.default_rng(sum(sizes))
    blocks = [rng.normal(size=(s, 6)).astype(np.float32) for s in sizes]
    jm, tm = _meshes("1d")
    ref = _reference_shards(jmesh.shard_items_from_blocks(jm, blocks))
    n = sum(sizes)
    per = tmesh.pad_to_mesh(n, tm) // 8
    # No host concatenate larger than one slot's block.
    seen = []
    real = np.concatenate

    def watched(parts, *a, **kw):
        out = real(parts, *a, **kw)
        seen.append(out.shape[0])
        return out

    monkeypatch.setattr(tmesh.np, "concatenate", watched)
    got = tmesh.shard_items_from_blocks(tm, blocks)
    monkeypatch.undo()
    assert all(s <= per for s in seen), (seen, per)
    for r, (_, t) in zip(ref, got.local()):
        assert np.array_equal(t.numpy(), r)


def test_shard_items_from_blocks_rejects_bad_blocks():
    tm = make_mesh(8, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="at least one shard"):
        tmesh.shard_items_from_blocks(tm, [])
    with pytest.raises(ValueError, match="equal F"):
        tmesh.shard_items_from_blocks(tm, [np.zeros((3, 4)), np.zeros((3, 5))])


def test_too_few_devices_raises_as_the_reference():
    with pytest.raises(ValueError) as ref:
        jmesh.make_mesh(9)
    with pytest.raises(ValueError) as got:
        make_mesh(9, devices=[CPU] * 8)
    assert str(got.value) == str(ref.value) == "requested 9 devices, only 8 available"
    with pytest.raises(ValueError, match="need 10 devices, have 8"):
        make_mesh_2d(2, 5, devices=[CPU] * 8)


def test_no_card_is_never_replaced_by_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(ValueError, match="requested 4 devices, only 0 available"):
        make_mesh(4)
    with pytest.raises(ValueError, match="requested 1 devices, only 0 available"):
        make_mesh(1)


def test_collectives_on_cpu_slots():
    tm = make_mesh(8, devices=[CPU] * 8)
    parts = [torch.full((2, 3), float(i)) for i in range(8)]
    st = tmesh.all_gather(tm, parts)
    assert st.shape == (8, 2, 3) and torch.equal(st[5], parts[5])
    tiled = tmesh.all_gather(tm, parts, tiled=True)
    assert tiled.shape == (16, 3) and torch.equal(tiled[10:12], parts[5])
    assert torch.equal(tmesh.psum(tm, parts), torch.full((2, 3), 28.0))
    assert torch.equal(tmesh.reduce(tm, parts, "min"), parts[0])
    assert torch.equal(tmesh.reduce(tm, parts, "max"), parts[7])
    ring = tmesh.ring_shift(tm, parts)
    assert [int(t[0, 0]) for t in ring] == [7, 0, 1, 2, 3, 4, 5, 6]
    rep = tmesh.replicate(tm, np.arange(4.0))
    assert rep.on(CPU) is rep.value and rep.value.dtype == torch.float64


def test_replicated_ell_graph_moves_whole():
    from matternet_rs_tpu_torch.ops.csr import EllLaplacian

    tm = make_mesh(2, devices=[CPU] * 2)
    ell = EllLaplacian(indices=torch.zeros((3, 2), dtype=torch.int32),
                       weights=torch.zeros((3, 2)), diag=torch.ones(3))
    rep = tmesh.replicate(tm, ell)
    assert isinstance(rep.on(CPU), EllLaplacian) and rep.on(CPU).diag.shape == (3,)


def test_local_map_runs_each_slot_with_its_shard():
    tm = make_mesh(4, devices=[CPU] * 4)
    xs = tmesh.shard_items(tm, np.arange(10, dtype=np.float32))
    out = tmesh.local_map(tm, lambda slot, part, c: (slot, part.sum().item() + c), xs, 100)
    assert [o[0] for o in out] == [0, 1, 2, 3]
    # rows 0-2, 3-5, 6-8, 9 + two zero rows
    assert [o[1] for o in out] == [103.0, 112.0, 121.0, 109.0]
    assert jax.device_count() == 8
