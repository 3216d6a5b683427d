"""What can be held about kernels B, D, E and F without a card: the launch
plans that mirror their C entry points, the plain versions of B and D
against the reference's Pallas kernels (interpret mode) at edge shapes,
that the rescored route tells kernel E its slab ids are in range (so it
reads nothing back to the host), and the build cache's handling of an
included header.

Tolerances: scores and maxima ≤ 1e-5 absolute (f32 summation order; the
plain versions and the Pallas kernels round the blend alike); bf16x3 scan
dots within 2⁻¹⁸·‖q‖·‖x‖ of the exact dot (the dropped lo·lo term) and of
the reference's own bf16x3 dots.
"""

import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matternet_rs_tpu.core import _quantize_rows_device_jit
from matternet_rs_tpu.ops.pallas import tilemax_fused as jtmf

from matternet_rs_tpu_torch import buildcache
from matternet_rs_tpu_torch import core as tcore
from matternet_rs_tpu_torch.ops import search as tso
from matternet_rs_tpu_torch.ops.kernels import _cuda
from matternet_rs_tpu_torch.ops.kernels import rescored as rsk
from matternet_rs_tpu_torch.ops.kernels import spmv_ell as fk
from matternet_rs_tpu_torch.ops.kernels import tilemax as ttmk

DTYPES = [torch.bfloat16, torch.int8, torch.float32]
WIDTHS = [1, 8, 16, 100, 127, 128, 200, 512, 768, 1024, 2047, 2048]
BATCHES = [1, 3, 16, 17, 64, 65, 256, 300, 1024]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("f", WIDTHS)
def test_tilemax_only_plan_fits_shared_memory_and_respects_alignment(dtype, f):
    esz = torch.empty((), dtype=dtype).element_size()
    for b in BATCHES:
        plan = rsk.tilemax_only_plan(b, f, dtype)
        # Every F ≤ 2048 holds at least 16 queries, whatever the loader.
        assert 0 < plan["smem_bytes"] <= rsk.MAX_DYNAMIC_SMEM == 232_448
        assert plan["queries_per_block"] in (16, 64, 256)
        if b <= 16:
            assert plan["queries_per_block"] == 16
        # A row pitch or an address off 16 bytes takes the element-wise loader
        # into the same shared-memory layout.
        assert plan["loader"] == ("elementwise" if (f * esz) % 16 else "cp.async")
        assert rsk.tilemax_only_plan(b, f, dtype, aligned=False) == dict(plan, loader="elementwise")


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_main_path_shape_takes_the_fast_path_with_all_queries_in_one_block(dtype):
    plan = rsk.tilemax_only_plan(256, 128, dtype)
    assert plan == dict(loader="cp.async", queries_per_block=256, smem_bytes=plan["smem_bytes"])
    assert plan["smem_bytes"] == (208_896 if dtype is torch.float32 else 143_360)
    # A batch past 256 takes further query blocks of the same width.
    assert rsk.tilemax_only_plan(300, 128, dtype)["queries_per_block"] == 256


def test_tilemax_only_plan_narrows_the_query_block_for_wide_rows():
    assert rsk.tilemax_only_plan(256, 768, torch.bfloat16)["queries_per_block"] == 64
    assert rsk.tilemax_only_plan(256, 768, torch.float32)["queries_per_block"] == 16
    assert rsk.tilemax_only_plan(256, 2048, torch.float32)["queries_per_block"] == 16
    # Past the fused range the slabs of even 16 queries stop fitting: refused.
    assert rsk.tilemax_only_plan(3, 2560, torch.float32)["queries_per_block"] == 16
    assert rsk.tilemax_only_plan(3, 5120, torch.int8)["queries_per_block"] == 16
    for f, dtype in ((2561, torch.float32), (5121, torch.bfloat16), (8192, torch.int8)):
        with pytest.raises(ValueError, match="no room for 16 queries"):
            rsk.tilemax_only_plan(256, f, dtype)


@pytest.mark.parametrize("f", WIDTHS)
def test_scores_tilemax_plan(f):
    for b in BATCHES:
        plan = ttmk.scores_tilemax_plan(b, f)
        assert plan["smem_bytes"] == 122_880 <= rsk.MAX_DYNAMIC_SMEM
        assert plan["loader"] == ("cp.async" if f % 4 == 0 else "elementwise")
        assert plan["blocks_per_tile"] == -(-b // 64)
        assert ttmk.scores_tilemax_plan(b, f, aligned=False)["loader"] == "elementwise"
    assert ttmk.scores_tilemax_plan(256, 128) == dict(
        loader="cp.async", smem_bytes=122_880, blocks_per_tile=4)


def _fixture(n, f, b, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f), dtype=np.float32)
    X[3] = 0.0                                 # exercises the zero-norm guards
    norms = np.sqrt(np.sum(X * X, axis=1)).astype(np.float32)
    lams = rng.random(n, dtype=np.float32)
    Q = rng.standard_normal((b, f), dtype=np.float32)
    ql = rng.random(b, dtype=np.float32)
    al = rng.uniform(0.3, 0.9, b).astype(np.float32)
    return X, norms, lams, Q, ql, al


def _close_where_finite(ref, got, tol):
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.max(np.abs(ref[fin] - got[fin])) <= tol


# n = 4500 gives n0 = 4096; mask_from = 3000 falls inside a sub-tile of 128
# rows (3000 = 23·128 + 56) and of 256 (11·256 + 184).
EDGE_SHAPES = [(3, 100, 16), (300, 100, 8), (3, 768, 8), (300, 768, 16)]


@pytest.mark.parametrize("mask_from", [None, 3000])
@pytest.mark.parametrize("mode", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("b,f,subs", EDGE_SHAPES)
def test_tilemax_only_plain_matches_pallas_at_edge_shapes(b, f, subs, mode, mask_from):
    X, norms, lams, Q, ql, al = _fixture(4500, f, b, seed=f + b)
    if mode == "int8":
        jx, jrn = _quantize_rows_device_jit(jnp.asarray(X))
        tx, trn = tcore.quantize_rows(torch.from_numpy(X))
    else:
        jdt, tdt = (jnp.bfloat16, torch.bfloat16) if mode == "bf16" else (jnp.float32, torch.float32)
        jx, jrn, tx, trn = jnp.asarray(X).astype(jdt), None, torch.from_numpy(X).to(tdt), None
    rest = [norms, lams, Q, ql, al]
    ref = np.asarray(jtmf.tilemax_only(
        jx, *[jnp.asarray(a) for a in rest], tile=2048, subs=subs, interpret=True, rn=jrn,
        mask_from=None if mask_from is None else jnp.int32(mask_from)))
    got = rsk.tilemax_only_plain(tx, *[torch.from_numpy(a) for a in rest], tile=2048,
                                 subs=subs, rn=trn, mask_from=mask_from).numpy()
    assert got.shape == ref.shape == (b, 2 * subs)
    _close_where_finite(ref, got, 1e-5)
    if mask_from is not None:                  # the sub-tile holding row 3000 is half masked
        ts = 2048 // subs
        assert np.all(np.isfinite(got[:, 3000 // ts])) and np.all(np.isinf(got[:, 3000 // ts + 1]))


@pytest.mark.parametrize("mask_from", [None, 3000])
@pytest.mark.parametrize("b,f", [(3, 100), (300, 100), (3, 768), (300, 768)])
def test_scores_and_tilemax_plain_matches_pallas_at_edge_shapes(b, f, mask_from):
    arrs = _fixture(4500, f, b, seed=2 * f + b)
    ref_s, ref_m = jtmf.scores_and_tilemax(
        *[jnp.asarray(a) for a in arrs], tile=2048, interpret=True,
        mask_from=None if mask_from is None else jnp.int32(mask_from))
    got_s, got_m = ttmk.scores_and_tilemax_plain(*[torch.from_numpy(a) for a in arrs],
                                                 tile=2048, mask_from=mask_from)
    assert got_s.shape == ref_s.shape == (b, 4096) and got_m.shape == ref_m.shape == (b, 16)
    _close_where_finite(np.asarray(ref_s), got_s.numpy(), 1e-5)
    _close_where_finite(np.asarray(ref_m), got_m.numpy(), 1e-5)


@pytest.mark.parametrize("f", [100, 128, 768])
def test_bf16x3_scan_dots_within_the_dropped_term_of_the_exact_dots(f):
    rng = np.random.default_rng(f)
    Q = rng.standard_normal((7, f), dtype=np.float32)
    X = (rng.standard_normal((300, f)) * rng.uniform(0.1, 10, (300, 1))).astype(np.float32)
    got = rsk.scan_dots_plain(torch.from_numpy(Q), torch.from_numpy(X)).numpy()
    scale = np.linalg.norm(Q, axis=1)[:, None] * np.linalg.norm(X, axis=1)[None, :]
    exact = Q.astype(np.float64) @ X.astype(np.float64).T
    assert np.all(np.abs(got - exact) <= 2.0 ** -18 * scale)
    ref = np.asarray(jtmf._scan_dots_kernel(jnp.asarray(Q), jnp.asarray(X)))
    assert np.all(np.abs(got - ref) <= 2.0 ** -18 * scale)


def test_rescore_subs_and_kernel_chunk_agree():
    """The main path's sub-tile (tile 2048 / 16) is kernel D's chunk: one
    128-row sub-tile is two 64-row warpgroup tiles."""
    assert tso.DEFAULT_TILE // tso.RESCORE_SUBS == rsk.KERNEL_CHUNK == 128
    assert tso.DEFAULT_TILE // ttmk.SUBS == ttmk.KERNEL_TS == 256


class _FakeCompiler:
    """Stands in for ``subprocess.Popen``: records argv and writes the
    output file the build expects."""
    calls: list = []

    def __init__(self, argv, **_kw):
        type(self).calls.append(list(argv))
        out = argv[argv.index("-o") + 1]
        with open(out, "wb") as fh:
            fh.write(b"so")
        self.returncode = 0

    def communicate(self, timeout=None):
        return "ptxas info    : Used 42 registers", None


def test_spec_hashes_a_header_it_does_not_compile(tmp_path, monkeypatch):
    src, hdr = tmp_path / "k.cu", tmp_path / "k.cuh"
    src.write_text('#include "k.cuh"\n')
    hdr.write_text("// v1\n")
    cmd = ("nvcc", "-O3")
    plain = buildcache.Spec("k", (src,), cmd)
    with_dep = buildcache.Spec("k", (src,), cmd, (hdr,))
    assert plain.deps == () and plain.target() != with_dep.target()
    before = with_dep.target()
    hdr.write_text("// v2\n")
    assert with_dep.target() != before          # the header's bytes enter the hash
    assert plain.target() == buildcache.Spec("k", (src,), cmd).target()

    monkeypatch.setattr(buildcache, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_FakeCompiler, "calls", [])
    monkeypatch.setattr(subprocess, "Popen", _FakeCompiler)
    spec = buildcache.Spec("k", (src,), cmd, (hdr,))
    (target,) = buildcache.build([spec])
    assert target.exists() and target.parent == tmp_path / "_build"
    (argv,) = _FakeCompiler.calls
    assert str(src) in argv and str(hdr) not in argv
    assert buildcache.BUILD_LOG["k"].endswith("42 registers")
    buildcache.build([spec])                    # cached: no second compiler run
    assert len(_FakeCompiler.calls) == 1
    monkeypatch.setattr(buildcache, "BUILD_LOG", {})
    buildcache.build([spec])                    # ... and no report of a build this process did not run
    assert len(_FakeCompiler.calls) == 1 and "k" not in buildcache.BUILD_LOG


def test_kernel_specs_hash_their_headers(monkeypatch):
    monkeypatch.setattr(_cuda, "nvcc_path", lambda: "/usr/local/cuda/bin/nvcc")
    specs = {s.name: s for s in _cuda.specs()}
    assert set(specs) == set(_cuda.SIGNATURES)
    for name, spec in specs.items():
        assert [p.name for p in spec.sources] == [f"{name}.cu"]
        assert [p.name for p in spec.deps] == list(_cuda.HEADERS.get(name, ()))
        for path in (*spec.sources, *spec.deps):
            assert path.is_file()
        # Every header the source includes from csrc/ is declared.
        text = spec.sources[0].read_text()
        included = {line.split('"')[1] for line in text.splitlines()
                    if line.startswith('#include "')}
        assert included == set(_cuda.HEADERS.get(name, ()))
    for name in ("tilemax", "search_fused"):
        assert "f32_tile_product.cuh" in _cuda.HEADERS[name]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_tilemax_only_operands_are_what_the_plain_version_uses(dtype):
    """The operands kernel D is launched on, formed on the CPU: the per-row
    factor, the per-query terms and the bf16 split of the queries are those
    of the plain version, so kernel and plain differ by the product alone."""
    X, norms, lams, Q, ql, al = [torch.from_numpy(a) for a in _fixture(4500, 64, 5, seed=9)]
    Xs, rn = tcore.quantize_rows(X) if dtype is torch.int8 else (X.to(dtype), None)
    ops = rsk._tilemax_only_operands(Xs, norms, lams, Q, ql, al, tile=2048, subs=16,
                                    mask_from=3000, rn=rn)
    assert ops["n0"] == 4096 and ops["ts"] == 128 and ops["mask_from"] == 3000
    assert rsk._tilemax_only_operands(Xs, norms, lams, Q, ql, al, subs=16)["mask_from"] == 4096
    want_rn, want_aqrn, want_beta = rsk._epilogue_terms(norms, Q, al, rn)
    assert torch.equal(ops["rn"], want_rn) and torch.equal(ops["aqrn"], want_aqrn)
    assert torch.equal(ops["beta"], want_beta) and ops["qhi"].dtype == torch.bfloat16
    assert torch.equal(ops["qhi"], Q.to(torch.bfloat16))
    if dtype is torch.float32:                 # hi + lo carries 16 bits of each query value
        assert torch.equal(ops["qlo"], (Q - ops["qhi"].float()).to(torch.bfloat16))
        assert float((ops["qhi"].float() + ops["qlo"].float() - Q).abs().max()) <= 2.0 ** -16 * float(Q.abs().max())
    else:
        assert ops["qlo"] is ops["qhi"]


@pytest.mark.parametrize("bad", ["subs", "dtype", "shape", "query_dtype", "width"])
def test_tilemax_only_operands_refuse_what_the_kernel_does_not_take(bad):
    f = 2600 if bad == "width" else 64          # 2600 f32 features: 16 queries' slabs do not fit
    X, norms, lams, Q, ql, al = [torch.from_numpy(a) for a in _fixture(2100, f, 5, seed=9)]
    kw = dict(tile=2048, subs=16)
    if bad == "subs":
        kw["subs"] = 32                         # 64-row sub-tiles: not a multiple of 128
    elif bad == "dtype":
        X = X.to(torch.float16)
    elif bad == "shape":
        Q = Q[:, :32]
    elif bad == "query_dtype":
        Q = Q.double()
    with pytest.raises(ValueError, match="tilemax_only kernel"):
        rsk._tilemax_only_operands(X, norms, lams, Q, ql, al, **kw)


# Kernel F's plan: (group, columns a lane per pass, rows a block of 128
# threads, passes) by m, pinned; blocks follow n.
SPMV_PLANS = {
    1: (1, 1, 128, 1), 2: (2, 1, 64, 1), 15: (16, 1, 8, 1), 16: (16, 1, 8, 1),
    17: (32, 1, 4, 1), 33: (32, 2, 4, 1), 256: (32, 8, 4, 1), 300: (32, 8, 4, 2),
}


@pytest.mark.parametrize("m", sorted(SPMV_PLANS))
def test_spmv_ell_plan_pins_groups_and_passes(m):
    group, cpt, rows, passes = SPMV_PLANS[m]
    for n in (1, 31, 16384):
        for k in (1, 14, 40):
            plan = fk.spmv_ell_plan(n, k, m)
            assert plan == dict(group=group, cols_per_lane=cpt, rows_per_block=rows,
                                blocks=-(-n // rows), passes=passes)
            # A group is the smallest power of two that holds min(m, 32)
            # columns; a pass covers group·cpt columns, the passes all of m.
            assert group >= min(m, 32) and (group == 1 or group // 2 < min(m, 32))
            assert plan["rows_per_block"] * group == fk.THREADS
            assert (passes - 1) * group * cpt < m <= passes * group * cpt
    assert fk.spmv_ell_plan(16384, 14, 15)["blocks"] == 2048      # LOBPCG's block at n = 16384
    assert fk.spmv_ell_plan(16384, 14, 1)["blocks"] == 128
    for bad in ((0, 14, 15), (16384, 0, 15), (16384, 14, 0)):
        with pytest.raises(ValueError, match="n, k, m >= 1"):
            fk.spmv_ell_plan(*bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8], ids=str)
@pytest.mark.parametrize("f", [1, 3, 100, 128, 768, 2048])
def test_slab_dots_plan_fits_and_respects_alignment(f, dtype):
    """Kernel E's launch at every F and (B, c), aligned and offset X: int8
    rows with F % 4 = 0, F ≤ 384 and X on 16 bytes take the ring (a
    persistent grid of min(B·c, 2·132) blocks, 96 KB of 128-row stages, at
    most 8); everything else one block a (query, slab) pair, the query in
    shared memory, vector reads only where F and the address allow them."""
    esz = torch.empty((), dtype=dtype).element_size()
    for b, c in ((1, 1), (7, 14), (256, 14)):
        for x_addr in (0, 4):                      # X aligned, and 4 bytes off
            got = rsk.slab_dots_plan(b, c, f, dtype, x_addr=x_addr)
            if esz == 1 and f % 4 == 0 and f <= 384 and x_addr == 0:
                stages, blocks = min(8, 96 * 1024 // (128 * f)), min(b * c, 264)
                assert got == dict(design="ring", reads="bulk", blocks=blocks, stages=stages,
                                   smem_bytes=stages * (128 * f + 8) + 8 * -(-b * c // blocks))
                continue
            # 16-byte reads of f32 rows need X on 16 bytes, 4-byte reads of
            # int8 rows X on 4; both need F % 4 == 0.
            vector = f % 4 == 0 and (x_addr == 0 or esz == 1)
            assert got == dict(design="pair", reads="vector" if vector else "element",
                               blocks=b * c, smem_bytes=4 * f, stages=0)
    assert rsk.slab_dots_plan(1, 1, f, dtype, x_addr=8)["reads"] == \
        ("vector" if f % 4 == 0 and esz == 1 else "element")


def test_slab_dots_plan_at_the_main_path_shape_and_past_the_fused_range():
    assert rsk.slab_dots_plan(256, 14, 128, torch.float32) == dict(
        design="pair", reads="vector", blocks=3584, smem_bytes=512, stages=0)
    assert rsk.slab_dots_plan(256, 14, 128, torch.int8) == dict(
        design="ring", reads="bulk", blocks=264, smem_bytes=6 * (16_384 + 8) + 8 * 14, stages=6)
    # Past 1,024 items a block the grid grows instead.
    big = rsk.slab_dots_plan(8192, 64, 96, torch.int8)
    assert big["blocks"] == 512 and big["smem_bytes"] == 8 * (12_288 + 8) + 8 * 1024
    assert rsk.slab_dots_plan(3, 2, 12_288, torch.float32)["smem_bytes"] == 49_152
    with pytest.raises(ValueError, match="passes 49152 bytes"):
        rsk.slab_dots_plan(3, 2, 12_289, torch.float32)
    for bad in ((0, 2, 128), (3, 0, 128), (3, 2, 0)):
        with pytest.raises(ValueError, match="must all be >= 1"):
            rsk.slab_dots_plan(*bad, torch.float32)


@pytest.mark.parametrize("ts,f,sms,want", [
    (128, 96, 132, dict(design="ring", reads="bulk", blocks=264, smem_bytes=8 * (12_288 + 8) + 112, stages=8)),
    (256, 96, 132, dict(design="ring", reads="bulk", blocks=264, smem_bytes=4 * (24_576 + 8) + 112, stages=4)),
    (128, 384, 132, dict(design="ring", reads="bulk", blocks=264, smem_bytes=2 * (49_152 + 8) + 112, stages=2)),
    (256, 384, 132, dict(design="pair", reads="vector", blocks=3584, smem_bytes=1536, stages=0)),
    (128, 388, 132, dict(design="pair", reads="vector", blocks=3584, smem_bytes=1552, stages=0)),
    (128, 96, 114, dict(design="ring", reads="bulk", blocks=228, smem_bytes=8 * (12_288 + 8) + 128, stages=8)),
])
def test_slab_dots_plan_of_the_sketch_path(ts, f, sms, want):
    """The sketch path's shape (B = 256, c = 14, int8 rows of F = 96): the
    ring, its stages from the slab's bytes, its grid from the SM count; a
    slab past 48 KB or F past 384 keeps the pair design."""
    assert rsk.slab_dots_plan(256, 14, f, torch.int8, ts=ts, sms=sms) == want


def test_rescored_route_tells_kernel_e_its_ids_are_in_range(monkeypatch):
    """``fused_scan_rescored``'s default slab reader calls ``slab_dots``
    with ``checked=True`` (no read-back of the ids); the hooks the plain
    runs pass stay as they were, and the result is the plain route's."""
    import inspect

    assert inspect.signature(tso.fused_scan_rescored).parameters["slab_reader"].default \
        is tso._slab_dots_checked
    assert inspect.signature(tso.fused_scan_rescored).parameters["producer"].default is rsk.tilemax_only
    X, norms, lams, Q, ql, al = [torch.from_numpy(a) for a in _fixture(40_000, 32, 6, seed=4)]
    calls = []
    real = rsk.slab_dots

    def recording(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(rsk, "slab_dots", recording)
    idx, top = tso.fused_scan_rescored(X, X, norms, lams, Q, ql, 10, 64, al)
    assert calls == [dict(checked=True)]
    pidx, ptop = tso.fused_scan_rescored(X, X, norms, lams, Q, ql, 10, 64, al,
                                         producer=rsk.tilemax_only_plain,
                                         slab_reader=rsk.slab_dots_plain)
    assert len(calls) == 1 and torch.equal(idx, pidx) and torch.equal(top, ptop)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8], ids=str)
def test_slab_dots_on_the_cpu_takes_the_plain_version_checked_or_not(dtype):
    X, _, _, Q, _, _ = [torch.from_numpy(a) for a in _fixture(2000, 24, 5, seed=8)]
    Xr = tcore.quantize_rows(X)[0] if dtype is torch.int8 else X
    sel = torch.sort(torch.randint(0, 2000 // 128, (5, 3), generator=torch.Generator().manual_seed(1)),
                     dim=1).values
    ref = rsk.slab_dots_plain(Xr, Q, sel, 128)
    for checked in (False, True):
        assert torch.equal(rsk.slab_dots(Xr, Q, sel, 128, checked=checked), ref)
