"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared object
with a plain C interface, loaded with ctypes. The build happens at first
use, into the git-ignored ``_build/`` directory, keyed by a hash of the
sources (:mod:`matternet_rs_tpu_torch.buildcache`); all sources compile at
once, one ``nvcc`` each. Every C entry point returns ``cudaGetLastError()``
after its launch and :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import torch

from matternet_rs_tpu_torch import buildcache
from matternet_rs_tpu_torch.backend import nvcc_path

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# library → {C function: argument types}; every function returns an int.
SIGNATURES = {
    "taumode": {
        # X, Wp, deg, deg2, tau, lam, partial, tickets, n, f, splits, stream
        "mrs_taumode_lambda": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _P],
        # X, n, f, vec (out), splits (out), grid (out), smem (out)
        "mrs_taumode_plan": [_P, _I64, _I, _P, _P, _P, _P],
        # X, L, b, f, mode, tau_fixed, k0, k1, mn, rng, raw, qlam, stream
        "mrs_taumode_query": [_P, _P, _I64, _I, _I, _F, _I, _I, _F, _F, _P, _P, _P],
        # b, f, rows (out), threads (out), chunk (out), smem (out)
        "mrs_taumode_query_plan": [_I64, _I, _P, _P, _P, _P],
    },
    "tilemax": {
        # X, norms, lams, Q, qn, ql, alpha, mask_from, n0, f, b,
        # scores, submax, stream
        "mrs_scores_tilemax": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I,
                               _P, _P, _P],
        # X, Q, f, vec (out), queries_per_block (out), smem (out)
        "mrs_scores_tilemax_plan": [_P, _P, _I, _P, _P, _P],
        # scores, sel, out, b, c, ts, n0, stream
        "mrs_gather_subtiles": [_P, _P, _P, _I, _I, _I, _I64, _P],
        # scores, submax, tail (or null), b, ns, nr, c, k, top, idx, stream
        "mrs_subtile_topk": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
        # scores, submax, tail (or null), b, ns, nr, c, k, cap, top, idx, stream
        "mrs_subtile_topk_wide": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
        # threads (out), cap (out)
        "mrs_subtile_topk_wide_plan": [_P, _P],
    },
    "rescored": {
        # X, rn, lams, qhi, qlo, aqrn, beta, ql, mask_from, n0, f, b, ts,
        # mode, out, stream
        "mrs_tilemax_only": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I,
                             _I, _P, _P],
        # X, f, b, mode, vec (out), nq (out), smem (out)
        "mrs_tilemax_only_plan": [_P, _I, _I, _I, _P, _P, _P],
        # X, Q, sel, out, b, c, ts, f, nslabs, int8_rows, design, stream
        "mrs_slab_dots": [_P, _P, _P, _P, _I, _I, _I, _I, _I64, _I, _I, _P],
        # X, b, c, ts, f, int8_rows, design (out), vec (out), blocks (out,
        # int64), smem (out), stages (out)
        "mrs_slab_dots_plan": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    },
    "spmv_ell": {
        # idx, w, X, d (or null), out, n, k, m, nx, row0, stream
        "mrs_spmv_ell": [_P, _P, _P, _P, _P, _I64, _I, _I, _I64, _I64, _P],
        # n, k, m, group (out), cols per lane (out), rows per block (out),
        # blocks (out, int64), passes (out)
        "mrs_spmv_ell_plan": [_I64, _I, _I, _P, _P, _P, _P, _P],
    },
    "search_fused": {
        # X, Q, n, f, b, k, splits, vec (out), tiles per split (out, int64),
        # blocks (out, int64): the plan of both scans
        "mrs_search_fused_scan_plan": [_P, _P, _I64, _I, _I, _I, _I, _P, _P, _P],
        # X, lams, Q, ql, alpha, beta, n, f, b, k, splits, pvals, pids, stream
        "mrs_search_fused_scan": [_P, _P, _P, _P, _F, _F, _I64, _I, _I, _I, _I, _P, _P, _P],
        # X, norms, lams, Q, qn, ql, n, f, b, k, splits, pvals, pids, stream
        "mrs_energy_scan": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _P, _P, _P],
        # pvals, pids, b, cand, k, vals, ids, stream
        "mrs_search_fused_merge": [_P, _P, _I, _I, _I, _P, _P, _P],
        # stream: an empty kernel (what one launch costs)
        "mrs_search_fused_empty": [_P],
    },
}

# library → headers under csrc/ that its source includes (they enter the
# build's hash; nvcc is given the .cu alone).
HEADERS = {
    "tilemax": ("div_rn.cuh", "f32_tile_product.cuh", "warp_topk.cuh"),
    "search_fused": ("div_rn.cuh", "f32_tile_product.cuh", "warp_topk.cuh"),
    "rescored": ("wgmma_bf16_rs.cuh",),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def specs() -> list[buildcache.Spec]:
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return [
        buildcache.Spec(name, (CSRC / f"{name}.cu",), (nvcc, *NVCC_FLAGS),
                        tuple(CSRC / h for h in HEADERS.get(name, ())))
        for name in SIGNATURES
    ]


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile (in parallel) and load every kernel library."""
    with _lock:
        if len(_libs) < len(SIGNATURES):
            for name, path in zip(SIGNATURES, buildcache.build(specs())):
                lib = ctypes.CDLL(str(path))
                for fn, argtypes in SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                lib.mrs_cuda_strerror.argtypes = [ctypes.c_int]
                lib.mrs_cuda_strerror.restype = ctypes.c_char_p
                _libs[name] = lib
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``; raises without a CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"CUDA kernel library {name!r} requested but no CUDA device is available"
        )
    return build_all()[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.mrs_cuda_strerror(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def require_cuda(what: str, **tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device, contiguous; returns the device."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{what}: tensors on several devices {sorted(map(str, devs))}")
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, not a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return devs.pop()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
