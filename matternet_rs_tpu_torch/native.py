"""ctypes binding of the port's own to ``native/clustering.cpp``.

The radius-gated incremental clustering scan is host C++ in both packages.
The port compiles the same source with g++ into its own build directory
(``buildcache.BUILD_DIR``), never into ``native/``, with the flags of
``native/Makefile`` so both libraries make the same floating-point
decisions. Without g++ the callers use the Python sequential scan.
"""

from __future__ import annotations

import ctypes
import logging
import pathlib
import shutil
import threading

import numpy as np

from matternet_rs_tpu_torch import buildcache

log = logging.getLogger(__name__)

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "native" / "clustering.cpp"
# native/Makefile's CXXFLAGS (no -ffast-math: it would change FP state).
CXXFLAGS = ("-O3", "-march=native", "-fopenmp-simd", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def spec() -> buildcache.Spec | None:
    cxx = shutil.which("g++")
    if cxx is None or not SOURCE.exists():
        return None
    return buildcache.Spec("mrs_clustering", (SOURCE,), (cxx, *CXXFLAGS))


def get_lib():
    """The loaded clustering library, or None without g++."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        s = spec()
        if s is None:
            log.warning("g++ or native/clustering.cpp missing; using the Python scan")
            return None
        try:
            (path,) = buildcache.build([s])
            lib = ctypes.CDLL(str(path))
        except (RuntimeError, OSError) as exc:
            log.warning("native clustering unavailable (%s); using the Python scan", exc)
            return None
        lib.mrs_incremental_cluster.restype = ctypes.c_int64
        lib.mrs_incremental_cluster.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def incremental_cluster(X: np.ndarray, max_clusters: int, radius: float,
                        keep_mask: np.ndarray | None = None):
    """Native scan in the reference's "legacy" mode. Returns
    ``(centroids [C,F] f32, assignments [N] i64, counts [C] i64)`` or None
    when the library is unavailable."""
    if int(max_clusters) < 1:
        raise ValueError(f"max_clusters must be >= 1, got {max_clusters}")
    lib = get_lib()
    if lib is None:
        return None
    X = np.ascontiguousarray(X, np.float32)
    n, f = X.shape
    cap = int(min(max_clusters, max(n, 1)))
    centroids = np.zeros((cap, f), np.float64)
    m2 = np.zeros((cap, f), np.float64)
    counts = np.zeros(cap, np.int64)
    assignments = np.zeros(n, np.int64)
    if keep_mask is not None:
        keep_mask = np.ascontiguousarray(keep_mask, np.uint8)
    ncent = int(lib.mrs_incremental_cluster(
        X.ctypes.data, n, f, cap, float(radius), 0,
        None if keep_mask is None else keep_mask.ctypes.data,
        centroids.ctypes.data, m2.ctypes.data,
        counts.ctypes.data, assignments.ctypes.data,
    ))
    if ncent < 0:
        raise RuntimeError("native incremental scan rejected its inputs (cap < 1)")
    return centroids[:ncent].astype(np.float32), assignments, counts[:ncent].copy()
