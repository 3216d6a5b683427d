"""Kernels D and E of the rescored search tiers (``csrc/rescored.cu``).

* :func:`tilemax_only` — kernel D, in place of the TPU kernel
  ``tilemax_fused.tilemax_only``: per-sub-tile maxima of the cheap blended
  score over the first ``n0 = (N // tile) * tile`` corpus rows, with no
  score matrix written. The scan precision follows the corpus dtype: bf16
  rows take one bf16 pass, int8 rows one pass over a lossless bf16 upcast
  (the dequant multiplier rides in ``rn``), f32 rows bf16x3.
* :func:`slab_dots` — kernel E, in place of ``tilemax_fused.slab_dots_ring``:
  each query's dots against every row of its selected ``ts``-row slabs;
  f32 rows at full f32, int8 rows upcast with the query rounded to bf16.

Each has its plain PyTorch version beside it, taken only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops import scores as score_ops
from matternet_rs_tpu_torch.ops._mm import mm, mm_bf16
from matternet_rs_tpu_torch.ops.kernels import _cuda
from matternet_rs_tpu_torch.ops.kernels.tilemax import SUBS

# Kernel D walks a sub-tile in chunks of this many corpus rows, so a
# sub-tile (tile // subs rows) must be a multiple of it — the reference's
# own rule (tile % (subs * 128) == 0).
KERNEL_CHUNK = 128
_SCAN_MODES = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}

# Kernel D's dynamic shared memory, as ``csrc/rescored.cu`` lays it out:
# query slabs of 64 features × 128 bytes a query (hi, and lo for f32 rows),
# two warpgroups' rings of four 64-row × 128-byte stages, the warps' partial
# maxima and the per-query terms, 1024 bytes of alignment slack.
MAX_DYNAMIC_SMEM = 232_448            # bytes a block may ask for on the H100
_STAGE_BYTES, _RING, _WARPGROUPS, _SMEM_ALIGN = 64 * 128, 4, 2, 1024
_QUERY_WIDTHS = (256, 64, 16)         # queries per block the kernel is built for


def _smem_bytes(f: int, esz: int, nq: int) -> int:
    kstage = 128 // esz                                   # features per stage
    kq = -(-(-(-f // kstage) * kstage) // 64) * 64        # whole stages, whole slabs
    slabs = (kq // 64) * nq * 128 * (2 if esz == 4 else 1)
    return (_SMEM_ALIGN + slabs + _WARPGROUPS * _RING * _STAGE_BYTES
            + (_WARPGROUPS * 4 + 3) * nq * 4)


def tilemax_only_plan(b: int, f: int, dtype: torch.dtype, aligned: bool = True) -> dict:
    """What the C entry point of kernel D chooses for a batch of ``b``
    queries over ``f`` features of corpus type ``dtype``, ``aligned`` saying
    whether the corpus address is a multiple of 16 bytes: the ``loader``
    (``"cp.async"``, 16-byte copies, or ``"elementwise"`` when the row pitch
    or the address is not a multiple of 16 bytes), the ``queries_per_block``
    (the narrowest of 16, 64, 256 that holds the batch, stepped down until
    the query slabs fit) and the ``smem_bytes`` it asks for. Raises
    ``ValueError`` when not even 16 queries fit (``f`` past 2560 for f32
    rows, 5120 for bf16 or int8 rows): the kernel refuses such a launch."""
    esz = torch.empty((), dtype=dtype).element_size()
    loader = "cp.async" if aligned and (f * esz) % 16 == 0 else "elementwise"
    for i, nq in enumerate(_QUERY_WIDTHS):
        needed = i == len(_QUERY_WIDTHS) - 1 or b > _QUERY_WIDTHS[i + 1]
        if needed and _smem_bytes(f, esz, nq) <= MAX_DYNAMIC_SMEM:
            return dict(loader=loader, queries_per_block=nq, smem_bytes=_smem_bytes(f, esz, nq))
    raise ValueError(f"tilemax_only kernel: {f} features of {dtype} rows leave no room for "
                     f"{_QUERY_WIDTHS[-1]} queries in {MAX_DYNAMIC_SMEM} bytes of shared memory")


def tilemax_only_plan_chosen(X, b: int) -> dict:
    """:func:`tilemax_only_plan` as the built library itself reports it for
    the corpus tensor ``X`` (on the card) and ``b`` queries."""
    lib = _cuda.library("rescored")
    vec, nq, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.mrs_tilemax_only_plan(X.data_ptr(), X.shape[1], b, _SCAN_MODES[X.dtype],
                                   ctypes.byref(vec), ctypes.byref(nq), ctypes.byref(smem))
    _cuda.check(lib, rc, "tilemax_only kernel plan")
    return dict(loader="cp.async" if vec.value else "elementwise",
                queries_per_block=nq.value, smem_bytes=smem.value)


def _epilogue_terms(norms, queries, alphas, rn):
    """``(rn, aqrn, beta)`` of the cheap epilogue, as ``tilemax_only``
    computes them: guarded ``1/norms`` unless ``rn`` is given,
    ``aqrn = α/max(qn, 1e-12)``, ``β = 1 − α``."""
    b = queries.shape[0]
    qn = torch.sqrt(torch.sum(queries * queries, dim=-1))
    a = score_ops.alpha_vector(alphas, b, queries.device)
    if rn is None:
        rn = torch.where(norms > 1e-12, 1.0 / torch.clamp(norms, min=1e-12),
                         torch.zeros_like(norms))
    else:
        rn = rn.to(torch.float32)
    return rn, a / score_ops.norm_floor(qn), 1.0 - a


def scan_dots_plain(queries, X):
    """``[B, n]`` scan dots at the precision ``X.dtype`` selects (bf16 and
    int8: one bf16 pass; f32: bf16x3 — both cross terms in one K = 2F
    product, then the hi·hi term, as the TPU kernel sums them)."""
    if X.dtype in (torch.bfloat16, torch.int8):
        return mm_bf16(queries, X.T)
    qhi = queries.to(torch.bfloat16)
    qlo = (queries - qhi.float()).to(torch.bfloat16)
    xhi = X.to(torch.bfloat16)
    xlo = (X - xhi.float()).to(torch.bfloat16)
    cross = mm_bf16(torch.cat([qhi, qlo], dim=1), torch.cat([xlo, xhi], dim=1).T)
    return cross + mm_bf16(qhi, xhi.T)


def tilemax_only_plain(X, norms, lambdas, queries, query_lambdas, alphas,
                       tile: int = 2048, subs: int = SUBS,
                       mask_from: int | None = None, rn=None):
    n, b = X.shape[0], queries.shape[0]
    n0 = (n // tile) * tile
    ts = tile // subs
    rn, aqrn, beta = _epilogue_terms(norms, queries, alphas, rn)
    s = scan_dots_plain(queries, X[:n0]) * rn[None, :n0] * aqrn[:, None]
    pen = torch.clamp(torch.abs(lambdas[None, :n0] - query_lambdas[:, None]), max=1.0)
    s = s + (beta[:, None] - beta[:, None] * pen)
    if mask_from is not None:
        col = torch.arange(n0, device=X.device)
        s = torch.where(col[None, :] >= mask_from, torch.full_like(s, -float("inf")), s)
    return s.view(b, n0 // ts, ts).amax(dim=2)


def _tilemax_only_operands(X, norms, lambdas, queries, query_lambdas, alphas,
                          tile: int = 2048, subs: int = SUBS,
                          mask_from: int | None = None, rn=None) -> dict:
    """Check the arguments of :func:`tilemax_only` for kernel D and form what
    its launch reads beside them: the per-row factor, the per-query terms and
    the queries as bf16 hi (and lo for f32 rows). Small PyTorch calls, no
    kernel of this package; :func:`_tilemax_only_launch` takes the result."""
    n, f = X.shape
    b = queries.shape[0]
    ts = tile // subs
    if tile % subs or ts % KERNEL_CHUNK:
        raise ValueError(f"tilemax_only kernel: sub-tile {tile}/{subs} must be a multiple of {KERNEL_CHUNK} rows")
    if X.dtype not in _SCAN_MODES:
        raise ValueError(f"tilemax_only kernel: corpus dtype {X.dtype} (bf16, int8 or float32)")
    if queries.shape != (b, f) or norms.shape != (n,) or lambdas.shape != (n,) \
            or query_lambdas.shape != (b,) or (rn is not None and rn.shape != (n,)):
        raise ValueError("tilemax_only kernel: inconsistent shapes")
    for name, t in dict(norms=norms, lambdas=lambdas, queries=queries,
                        query_lambdas=query_lambdas).items():
        if t.dtype != torch.float32:
            raise ValueError(f"tilemax_only kernel: {name} must be float32, got {t.dtype}")
    tilemax_only_plan(b, f, X.dtype)            # raises for an F the kernel refuses
    rn, aqrn, beta = _epilogue_terms(norms, queries, alphas, rn)
    qhi = queries.to(torch.bfloat16)
    qlo = (queries - qhi.float()).to(torch.bfloat16) if X.dtype == torch.float32 else qhi
    n0 = (n // tile) * tile
    return dict(X=X, rn=rn, lambdas=lambdas, qhi=qhi, qlo=qlo, aqrn=aqrn, beta=beta,
                query_lambdas=query_lambdas, n0=n0, ts=ts,
                mask_from=n0 if mask_from is None else int(mask_from))


def _tilemax_only_launch(ops: dict):
    """Launch kernel D on the operands of :func:`_tilemax_only_operands` →
    ``submax [B, n0 // ts]``."""
    lib = _cuda.library("rescored")
    tensors = {k: v for k, v in ops.items() if isinstance(v, torch.Tensor)}
    dev = _cuda.require_cuda("tilemax_only kernel", **tensors)
    X, n0, ts = ops["X"], ops["n0"], ops["ts"]
    b, f = ops["qhi"].shape
    out = torch.empty((b, n0 // ts), dtype=torch.float32, device=dev)
    if n0 == 0 or b == 0:
        return out
    rc = lib.mrs_tilemax_only(
        X.data_ptr(), ops["rn"].data_ptr(), ops["lambdas"].data_ptr(), ops["qhi"].data_ptr(),
        ops["qlo"].data_ptr(), ops["aqrn"].data_ptr(), ops["beta"].data_ptr(),
        ops["query_lambdas"].data_ptr(), ops["mask_from"], n0, f, b, ts, _SCAN_MODES[X.dtype],
        out.data_ptr(), _cuda.stream_ptr(dev),
    )
    _cuda.check(lib, rc, "tilemax_only kernel")
    kernels.count("tilemax_only")
    return out


def tilemax_only(X, norms, lambdas, queries, query_lambdas, alphas,
                 tile: int = 2048, subs: int = SUBS,
                 mask_from: int | None = None, rn=None):
    """Returns ``submax [B, nt0·subs]``: sub-tile ``j`` covers corpus rows
    ``[j·ts, (j+1)·ts)``, ``ts = tile // subs``. ``rn`` overrides the
    per-row cosine factor (default guarded ``1/norms``; the int8 tier
    passes its dequant multiplier). Rows ≥ ``mask_from`` score -inf. CPU
    tensors take the plain version; CUDA tensors launch kernel D (any B;
    ``ts`` a multiple of 128; F as far as :func:`tilemax_only_plan` allows)."""
    if X.device.type == "cpu":
        return tilemax_only_plain(X, norms, lambdas, queries, query_lambdas, alphas,
                                  tile, subs, mask_from, rn)
    _cuda.library("rescored")                 # without a card: raise before anything is computed
    return _tilemax_only_launch(_tilemax_only_operands(
        X, norms, lambdas, queries, query_lambdas, alphas, tile, subs, mask_from, rn))


def slab_dots_plain(X, queries, sel, ts: int):
    b, c = sel.shape
    rows = (sel[:, :, None] * ts + torch.arange(ts, device=sel.device)).reshape(b, c * ts)
    Xs = X[rows]                                            # [B, c·ts, F]
    if X.dtype == torch.int8:
        d = mm_bf16(Xs, queries[:, :, None])
    else:
        d = mm(Xs, queries[:, :, None])
    return d.view(b, c, ts)


_SLAB_MAX_SMEM = 48 * 1024            # kernel E's query in shared memory (the pair design)
# The ring of kernel E for int8 rows (csrc/rescored.cu): blocks an SM, the
# bytes of a block's stages, its most stages, the largest slab and F.
_RING_BLOCKS_PER_SM, _RING_BYTES, _RING_MAX_STAGES = 2, 96 * 1024, 8
_RING_MAX_SLAB, _RING_MAX_F = 48 * 1024, 384
_RING_MAX_ITEMS = 1024               # slab ids a ring block stages in shared memory
_H100_SMS = 132
_DESIGNS = {"pair": 0, "ring": 1}


def slab_dots_plan(b: int, c: int, f: int, dtype: torch.dtype, x_addr: int = 0, ts: int = 128,
                   sms: int = _H100_SMS) -> dict:
    """What the C entry point of kernel E chooses for ``b`` queries of ``c``
    slabs of ``ts`` rows, ``f`` features of ``dtype`` rows (float32 or
    int8) at address ``x_addr``, on a card of ``sms`` SMs: the ``design``
    (``"ring"``: int8 rows with F % 4 = 0, F ≤ 384, a slab of at most 48 KB
    and a multiple of 16 bytes, X on 16 bytes — a persistent grid of
    ``blocks`` = min(b·c, 2·sms) whose ``stages`` slab copies are in flight
    by ``cp.async.bulk`` (more blocks where one would take more than 1,024
    items); ``"pair"`` otherwise — one block a (query, slab)
    pair), its ``reads`` (the ring's ``"bulk"``; the pair design's
    ``"vector"``, 16-byte reads of f32 rows or 4-byte reads of int8 rows
    when F % 4 = 0 and the address allows it, else ``"element"``) and the
    ``smem_bytes`` it asks for (the pair design: the query; the ring: its
    stages, their barriers and its slab ids). Raises ``ValueError`` where the launch
    would be refused: the pair design's query past 48 KB (past 12,288
    features), or an empty shape."""
    if min(b, c, f, ts) < 1:
        raise ValueError(f"slab_dots kernel: b={b}, c={c}, f={f}, ts={ts} must all be >= 1")
    slab = ts * f
    if (dtype == torch.int8 and f % 4 == 0 and f <= _RING_MAX_F and slab % 16 == 0
            and slab <= _RING_MAX_SLAB and x_addr % 16 == 0 and b * c < 2**31):
        stages = min(_RING_MAX_STAGES, _RING_BYTES // slab)
        blocks = min(b * c, max(_RING_BLOCKS_PER_SM * sms, -(-b * c // _RING_MAX_ITEMS)))
        return dict(design="ring", reads="bulk", blocks=blocks,
                    smem_bytes=stages * (slab + 8) + 8 * -(-b * c // blocks), stages=stages)
    if 4 * f > _SLAB_MAX_SMEM:
        raise ValueError(f"slab_dots kernel: a query of {f} features passes {_SLAB_MAX_SMEM} bytes")
    vec = f % 4 == 0 and x_addr % (4 if dtype == torch.int8 else 16) == 0
    return dict(design="pair", reads="vector" if vec else "element", blocks=b * c,
                smem_bytes=4 * f, stages=0)


def slab_dots_plan_chosen(X, b: int, c: int, ts: int = 128) -> dict:
    """:func:`slab_dots_plan` as the built library itself reports it for the
    rows ``X`` on the card."""
    lib = _cuda.library("rescored")
    design, vec, smem, stages = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    blocks = ctypes.c_int64()
    rc = lib.mrs_slab_dots_plan(X.data_ptr(), b, c, ts, X.shape[1], int(X.dtype == torch.int8),
                                ctypes.byref(design), ctypes.byref(vec), ctypes.byref(blocks),
                                ctypes.byref(smem), ctypes.byref(stages))
    _cuda.check(lib, rc, "slab_dots kernel plan")
    reads = "bulk" if design.value else "vector" if vec.value else "element"
    return dict(design="ring" if design.value else "pair", reads=reads, blocks=blocks.value,
                smem_bytes=smem.value, stages=stages.value)


def _slab_dots_launch(X, queries, sel, ts: int, out, design: str | None = None) -> None:
    """Launch kernel E into ``out [B, c, ts]`` on arguments that
    :func:`slab_dots` has checked; ``design`` (``"pair"`` or ``"ring"``)
    overrides the plan, for timing one design against the other."""
    lib = _cuda.library("rescored")
    b, c = sel.shape
    rc = lib.mrs_slab_dots(
        X.data_ptr(), queries.data_ptr(), sel.data_ptr(), out.data_ptr(), b, c, ts, X.shape[1],
        X.shape[0] // ts, int(X.dtype == torch.int8), -1 if design is None else _DESIGNS[design],
        _cuda.stream_ptr(out.device),
    )
    _cuda.check(lib, rc, "slab_dots kernel")
    kernels.count("slab_dots")


def slab_dots(X, queries, sel, ts: int, *, checked: bool = False):
    """``d[b, i, r] = queries[b] · X[sel[b, i]·ts + r]`` → ``[B, c, ts]``.
    ``X`` f32 (full-f32 dots) or int8 (lossless upcast, the query rounded
    to bf16); ``sel [B, c]`` int64 slab ids, each in ``[0, N // ts)``. CPU
    tensors take the plain version; CUDA tensors launch kernel E (the design
    :func:`slab_dots_plan` names). Unless
    ``checked`` (the caller made the ids in range itself), an out-of-range
    id raises ``ValueError`` before the launch, which reads the ids back to
    the host; with ``checked=True`` nothing is read back, and the kernel
    answers an out-of-range id with a NaN slice."""
    if X.device.type == "cpu":
        return slab_dots_plain(X, queries, sel, ts)
    _cuda.library("rescored")                 # without a card: raise before anything is computed
    n, f = X.shape
    b, c = sel.shape
    if queries.shape != (b, f) or queries.dtype != torch.float32:
        raise ValueError(f"slab_dots kernel: queries {tuple(queries.shape)} {queries.dtype}, want ({b}, {f}) float32")
    if sel.dtype != torch.int64 or X.dtype not in (torch.float32, torch.int8):
        raise ValueError("slab_dots kernel: sel int64 and X float32 or int8 required")
    dev = _cuda.require_cuda("slab_dots kernel", X=X, queries=queries, sel=sel)
    nslabs = n // ts
    out = torch.empty((b, c, ts), dtype=torch.float32, device=dev)
    if b == 0 or c == 0:
        return out
    if not checked:
        lo, hi = torch.stack(torch.aminmax(sel)).tolist()
        if lo < 0 or hi >= nslabs:
            raise ValueError(f"slab_dots kernel: slab ids span [{lo}, {hi}], corpus has {nslabs} slabs")
    _slab_dots_launch(X, queries, sel, ts, out)
    return out
