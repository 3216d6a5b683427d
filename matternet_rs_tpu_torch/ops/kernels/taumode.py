"""Kernel A: raw taumode λ per row (``csrc/taumode.cu``).

Replaces the TPU kernels ``taumode_fused.taumode_lambdas_pallas`` and
``taumode_lambdas_pallas_bigf``: one kernel serves F ≤ ``MAX_KERNEL_F``.
It runs the seven products on the tensor cores in 3xTF32: each operand is
split into a TF32 high part and a TF32 low part and each product is
``hi·hi + hi·lo + lo·hi`` summed in f32. The plain version beside it is the
reference's closed form at full f32 with τ given; it is the standard the
kernel is held to (1e-5·max(|λ|, 1)). :func:`taumode_lambdas_3xtf32_plain`
repeats the kernel's arithmetic for the tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops._mm import mm
from matternet_rs_tpu_torch.ops.kernels import _cuda

TAU_FLOOR = 1e-10
ZERO_VEC_EPS = 1e-10
# Kernel limit: the prepared operand is 3 × 2 × Fp² floats, Fp = F rounded
# up to 32 (100 MB at 2048).
MAX_KERNEL_F = 2048

# Kernel A's launch plan, as ``csrc/taumode.cu`` makes it: 128-row tiles,
# 32-feature chunks, a ring of five 40 KB stages (six 4 KB tiles of the
# operand and the 16 KB X chunk), a barrier per stage, a flag, 1024 bytes
# of alignment slack: the same for every F.
MAX_DYNAMIC_SMEM = 232_448            # bytes a block may ask for on the H100
_ROWS, _KCH, _STAGES, _SMEM_ALIGN = 128, 32, 5, 1024
_SMEM_BYTES = _SMEM_ALIGN + _STAGES * (6 * 4096 + _ROWS * _KCH * 4) + _STAGES * 8 + 16
MAX_SPLITS = 8                        # column splits of a row tile at most
_SUMS = 5                             # partial sums a row and split: nume, den, total, num4, max|x|


def operator_weights(L: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``A = max(-L, 0)`` with the diagonal zeroed, and the row sums of A
    and A∘A (``deg``, ``deg2``)."""
    A = torch.clamp(-L, min=0.0)
    A = A - torch.diag(torch.diag(A))
    return A, A.sum(dim=1), (A * A).sum(dim=1)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32``: add half a unit to the
    magnitude's bits and clear the 13 dropped bits."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, ~0x1FFF).view(torch.float32)


def _product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel forms it: ``hi·hi + hi·lo + lo·hi`` with
    ``hi = tf32(v)``, ``lo = tf32(v − hi)``; each TF32 × TF32 product is
    exact in f32, the sums are f32."""
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return mm(ah, bh) + mm(ah, bl) + mm(al, bh)


def _lambdas(X: torch.Tensor, L: torch.Tensor, tau: torch.Tensor, product,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Closed form in ``dtype``: seven ``[N,F]×[F,F]`` products by
    ``product`` and the λ tail, with per-row ``tau [N]``. Rows with
    max|x| ≤ 1e-10 score 0."""
    X = X.to(dtype)
    L = L.to(dtype)
    tau = tau.to(dtype)
    XL = product(X, L)
    num_e = torch.sum(X * XL, dim=-1)
    den = torch.sum(X * X, dim=-1)
    zero = torch.zeros_like(den)
    e_raw = torch.where(den > 1e-12, num_e / torch.clamp(den, min=1e-12), zero)
    e_raw = torch.clamp(e_raw, min=0.0)

    A, deg, deg2 = operator_weights(L)
    A2 = A * A
    X2 = X * X
    X3 = X2 * X
    X4 = X2 * X2
    B1 = product(X, A)
    B2 = product(X2, A)
    C1 = product(X, A2)
    C2 = product(X2, A2)
    C3 = product(X3, A2)
    C4 = product(X4, A2)
    total = torch.sum(X2 * deg - 2.0 * X * B1 + B2, dim=-1)
    num4 = torch.sum(
        X4 * deg2 - 4.0 * X3 * C1 + 6.0 * X2 * C2 - 4.0 * X * C3 + C4, dim=-1
    )
    g = torch.where(total > 1e-12, num4 / torch.clamp(total * total, min=1e-24), zero)
    g = torch.clamp(g, 0.0, 1.0)

    e_bounded = torch.where(
        e_raw + tau > 0, e_raw / torch.clamp(e_raw + tau, min=TAU_FLOOR), zero
    )
    lam = tau * e_bounded + (1.0 - tau) * g
    is_zero = torch.amax(torch.abs(X), dim=-1) <= ZERO_VEC_EPS
    return torch.where(is_zero, zero, lam)


def taumode_lambdas_plain(X: torch.Tensor, L: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """The closed form at full f32: seven ``[N,F]×[F,F]`` products and the
    λ tail, with per-row ``tau [N]``. Rows with max|x| ≤ 1e-10 score 0."""
    return _lambdas(X, L, tau, mm)


def taumode_lambdas_f64(X: torch.Tensor, L: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """The closed form in float64, as a yardstick for the float32 versions:
    on rows where the expanded sums cancel (few features of nearly equal
    value) the float32 form itself strays from it. For checks only."""
    return _lambdas(X, L, tau, torch.matmul, torch.float64)


def taumode_rounding_bound(X: torch.Tensor, L: torch.Tensor, tau: torch.Tensor,
                           eps: float) -> torch.Tensor:
    """First-order bound ``[N]`` on how far λ computed with products of
    relative error ``eps`` (of the sum of their terms' magnitudes) can lie
    from the exact value. The sums behind E and G cancel where a row's
    features are nearly equal (total = Σ A_ij (x_i − x_j)², num4 likewise
    with A∘A and fourth powers): there each is the small difference of
    large terms, and the bound grows with the ratio of the terms'
    magnitudes to the result. Evaluated in float64. For checks only."""
    X, L, tau = X.double(), L.double(), tau.double()
    A, deg, deg2 = operator_weights(L)
    A2, ax = A * A, X.abs()
    m_nume = torch.sum(ax * (ax @ L.abs()), dim=-1)
    m_total = torch.sum(X * X * deg + 2 * ax * (ax @ A) + (X * X) @ A, dim=-1)
    m_num4 = torch.sum(X ** 4 * deg2 + 4 * ax ** 3 * (ax @ A2) + 6 * X * X * ((X * X) @ A2)
                       + 4 * ax * (ax ** 3 @ A2) + X ** 4 @ A2, dim=-1)
    nume = torch.sum(X * (X @ L), dim=-1)
    den = torch.sum(X * X, dim=-1)
    total = torch.sum(X * X * deg - 2 * X * (X @ A) + (X * X) @ A, dim=-1)
    num4 = torch.sum(X ** 4 * deg2 - 4 * X ** 3 * (X @ A2) + 6 * X * X * ((X * X) @ A2)
                     - 4 * X * (X ** 3 @ A2) + X ** 4 @ A2, dim=-1)
    tiny = torch.finfo(torch.float64).tiny
    e = torch.clamp(nume / torch.clamp(den, min=1e-12), min=0.0)
    d_e = eps * (m_nume + den) / torch.clamp(den, min=1e-12)          # |δE|
    g = num4 / torch.clamp(total * total, min=1e-24)
    d_g = eps * (m_num4 / torch.clamp(total * total, min=tiny)
                 + 2 * g.abs() * m_total / torch.clamp(total.abs(), min=tiny))   # |δG|
    bound = (tau * tau).abs() / torch.clamp((e + tau) ** 2, min=1e-20) * d_e + (1 - tau).abs() * d_g
    return torch.where(den > 1e-12, bound, torch.zeros_like(bound))


def taumode_lambdas_3xtf32_plain(X: torch.Tensor, L: torch.Tensor,
                                 tau: torch.Tensor) -> torch.Tensor:
    """The closed form with kernel A's arithmetic: every product in 3xTF32
    (TF32 rounding by bit mask, the three partial products summed in f32).
    For tests and the card's checks only."""
    return _lambdas(X, L, tau, _product_3xtf32)


def _padded(f: int) -> int:
    return -(-f // _KCH) * _KCH


def taumode_plan(n: int, f: int, aligned: bool = True, sms: int = 132) -> dict:
    """What the C entry point of kernel A chooses for ``n`` rows of ``f``
    features on a card of ``sms`` multiprocessors, ``aligned`` saying
    whether X's address is a multiple of 16 bytes: the ``loader`` of X
    (``"tma"``, one tensor copy a chunk, or ``"elementwise"`` when F % 4 ≠ 0
    or the address is off 16 bytes), the column ``splits`` of a 128-row tile
    (the smallest count ≤ 8 whose work items fill the SMs' waves to 90%,
    else the count that fills them best), the ``grid`` and the
    ``smem_bytes`` it asks for. Raises ``ValueError`` for F outside
    [1, MAX_KERNEL_F] or n < 1."""
    if not 1 <= f <= MAX_KERNEL_F or n < 1:
        raise ValueError(f"taumode kernel takes 1 <= F <= {MAX_KERNEL_F} and N >= 1, got F={f}, N={n}")
    nct = _padded(f) // _KCH
    row_tiles = -(-n // _ROWS)
    splits, best_items, best_waves = 1, 0, 1
    for s in range(1, min(MAX_SPLITS, nct) + 1):
        cpt = -(-nct // s)
        if -(-nct // cpt) != s:                   # some item would have no columns
            continue
        items = row_tiles * s
        waves = -(-items // sms)
        if 10 * items >= 9 * waves * sms:
            splits = s
            break
        if items * best_waves > best_items * waves:
            splits, best_items, best_waves = s, items, waves
    return dict(loader="tma" if aligned and f % 4 == 0 else "elementwise",
                splits=splits, grid=min(row_tiles * splits, sms),
                smem_bytes=_SMEM_BYTES)


def taumode_plan_chosen(X: torch.Tensor) -> dict:
    """:func:`taumode_plan` as the built library itself reports it for the
    tensor ``X [n, f]`` on the card."""
    lib = _cuda.library("taumode")
    vec, splits, grid, smem = (ctypes.c_int() for _ in range(4))
    rc = lib.mrs_taumode_plan(X.data_ptr(), X.shape[0], X.shape[1], ctypes.byref(vec),
                              ctypes.byref(splits), ctypes.byref(grid), ctypes.byref(smem))
    _cuda.check(lib, rc, "taumode kernel plan")
    return dict(loader="tma" if vec.value else "elementwise", splits=splits.value,
                grid=grid.value, smem_bytes=smem.value)


@functools.lru_cache(maxsize=8)
def _operand_sources(fp: int, device: torch.device) -> torch.Tensor:
    """For each float of the prepared operand's tiles ``[c, kc, r, pos]``,
    its index ``k·Fp + n`` in a padded ``[Fp, Fp]`` part: column ``n = 32c
    + r``, feature ``k = 32kc + φ(j)`` for the slot ``j`` that the 128-byte
    swizzle stores at ``pos`` (unit ``u`` of row ``r`` lands at ``u ^ (r %
    8)``), ``φ(8s + q) = 8(q % 4) + 2s + q // 4``."""
    nct = fp // _KCH
    c, kc, r, pos = torch.meshgrid(*(torch.arange(m) for m in (nct, nct, 32, 32)), indexing="ij")
    j = ((pos // 4) ^ (r % 8)) * 4 + pos % 4
    s, q = j // 8, j % 8
    k = 32 * kc + 8 * (q % 4) + 2 * s + q // 4
    return (k * fp + 32 * c + r).reshape(-1).to(device)


def prepared_operand(L: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Kernel A's B operand as the stages of its ring hold it: for W = (L,
    A, A∘A) (A from :func:`operator_weights`) zero-padded to Fp = F rounded
    up to 32, the TF32 high and low parts of ``W[k, n]`` in 4 KB tiles
    ``[part, hl, c, kc, r, j]`` — output column ``n = 32c + r``, feature
    ``32kc + φ(j)`` — where slot ``j = 8s + q`` holds feature ``φ(j) =
    8(q % 4) + 2s + q // 4`` (the order the kernel's register operand reads
    them) and each 128-byte row keeps its 16-byte unit ``u`` at ``u ^ (r %
    8)`` (the swizzle the ``wgmma`` descriptor reads)."""
    f = L.shape[0]
    fp = _padded(f)
    nct = fp // _KCH
    W = torch.zeros((3, fp, fp), dtype=torch.float32, device=L.device)
    W[:, :f, :f] = torch.stack([L, A, A * A])
    W = W.view(3, fp * fp)[:, _operand_sources(fp, L.device)]
    hi = tf32_round(W)
    return torch.stack([hi, tf32_round(W - hi)], dim=1).view(3, 2, nct, nct, 32, 32)


def _operands(X: torch.Tensor, L: torch.Tensor, tau: torch.Tensor) -> tuple:
    """Kernel A's launch, checked and prepared on the card: the library, the
    output, the prepared operand and degrees, the scratch of a split plan,
    and the scalars. Raises on what the kernel does not take."""
    lib = _cuda.library("taumode")
    n, f = X.shape
    if L.shape != (f, f) or tau.shape != (n,):
        raise ValueError(f"taumode kernel: X {tuple(X.shape)}, L {tuple(L.shape)}, tau {tuple(tau.shape)}")
    for name, t in (("X", X), ("L", L), ("tau", tau)):
        if t.dtype != torch.float32:
            raise ValueError(f"taumode kernel: {name} must be float32, got {t.dtype}")
    dev = _cuda.require_cuda("taumode kernel", X=X, L=L, tau=tau)
    lam = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return lib, lam, None
    plan = taumode_plan(n, f, X.data_ptr() % 16 == 0,
                        torch.cuda.get_device_properties(dev).multi_processor_count)
    A, deg, deg2 = operator_weights(L)
    partial = tickets = None
    if plan["splits"] > 1:
        partial = torch.empty(plan["splits"] * n * _SUMS, dtype=torch.float32, device=dev)
        tickets = torch.zeros(-(-n // _ROWS), dtype=torch.int32, device=dev)
    return lib, lam, (X, prepared_operand(L, A), deg, deg2, tau, partial, tickets, plan["splits"], dev)


def _launch(lib, lam: torch.Tensor, args) -> torch.Tensor:
    """Launch kernel A on operands from :func:`_operands`; counts it."""
    if args is None:
        return lam
    X, Wp, deg, deg2, tau, partial, tickets, splits, dev = args
    n, f = X.shape
    rc = lib.mrs_taumode_lambda(
        X.data_ptr(), Wp.data_ptr(), deg.data_ptr(), deg2.data_ptr(), tau.data_ptr(),
        lam.data_ptr(), None if partial is None else partial.data_ptr(),
        None if tickets is None else tickets.data_ptr(), n, f, splits, _cuda.stream_ptr(dev),
    )
    _cuda.check(lib, rc, "taumode kernel")
    kernels.LAUNCHES["taumode"] += 1
    return lam


def taumode_lambdas_fused(X: torch.Tensor, L: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Raw λ ``[N]`` of ``X [N,F]`` against ``L [F,F]`` with per-row τ.
    CPU tensors take the plain version; CUDA tensors launch kernel A."""
    if X.device.type == "cpu":
        return taumode_lambdas_plain(X, L, tau)
    return _launch(*_operands(X, L, tau))
