"""The port's own ctypes bindings of ``native/clustering.cpp`` and
``native/shard_reader.cpp``.

The radius-gated incremental clustering scan and the shard store's
read-ahead reader are host C++ in both packages. The port compiles the
same sources with g++ into its own build directory
(``buildcache.BUILD_DIR``), never into ``native/``, with the flags of
``native/Makefile`` (so both clustering libraries make the same
floating-point decisions), one library each. Without g++ the callers use
the Python sequential scan and the Python memmap reader.
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

NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
SOURCE = NATIVE_DIR / "clustering.cpp"
SHARD_SOURCE = NATIVE_DIR / "shard_reader.cpp"
# native/Makefile's CXXFLAGS (no -ffast-math: it would change FP state).
CXXFLAGS = ("-O3", "-march=native", "-fopenmp-simd", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False
_shard_lib = None
_shard_tried = False


def _spec(name: str, source: pathlib.Path, libs: tuple[str, ...] = ()) -> buildcache.Spec | None:
    cxx = shutil.which("g++")
    if cxx is None or not source.exists():
        return None
    return buildcache.Spec(name, (source,), (cxx, *CXXFLAGS), libs=libs)


def spec() -> buildcache.Spec | None:
    """The clustering library's build, or None without g++."""
    return _spec("mrs_clustering", SOURCE)


def shard_reader_spec() -> buildcache.Spec | None:
    """The shard reader's build (its read-ahead thread: ``-lpthread``), or
    None without g++."""
    return _spec("mrs_shard_reader", SHARD_SOURCE, ("-lpthread",))


def _load(s: buildcache.Spec | None, what: str):
    """Build (if needed) and load ``s``'s library; None, with a warning,
    without g++ or on a failed build."""
    if s is None:
        log.warning("g++ or the %s source is missing; using the Python path", what)
        return None
    try:
        (path,) = buildcache.build([s])
        return ctypes.CDLL(str(path))
    except (RuntimeError, OSError) as exc:
        log.warning("native %s unavailable (%s); using the Python path", what, exc)
        return None


def get_lib():
    """The loaded clustering library, or None without g++."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib = _load(spec(), "clustering")
        if lib is None:
            return None
        lib.mrs_incremental_cluster.restype = ctypes.c_int64
        lib.mrs_incremental_cluster.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.mrs_nearest_centroid.restype = None
        lib.mrs_nearest_centroid.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the clustering library built and loaded."""
    return get_lib() is not None


def incremental_cluster(X: np.ndarray, max_clusters: int, radius: float,
                        mode: str = "legacy", keep_mask: np.ndarray | None = None):
    """Native radius-gated incremental scan. ``mode``: ``"legacy"`` (the
    eigen build's semantics, soft outliers included) or ``"stage_a"`` (the
    staged pipeline's stage A: assign, create, else force-assign). Returns
    ``(centroids [C,F] f32, assignments [N] i64 (-1 = dropped), counts [C]
    i64, m2 [C,F] f64)`` or None when the library is unavailable."""
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
        X.ctypes.data, n, f, cap, float(radius), {"legacy": 0, "stage_a": 1}[mode],
        None if keep_mask is None else keep_mask.ctypes.data,
        centroids.ctypes.data, m2.ctypes.data,
        counts.ctypes.data, assignments.ctypes.data,
    ))
    if ncent < 0:
        raise RuntimeError("native incremental scan rejected its inputs (cap < 1)")
    # Copies, so the results do not pin the [cap, F] buffers.
    return (centroids[:ncent].astype(np.float32), assignments, counts[:ncent].copy(),
            m2[:ncent].copy())


def nearest_centroid_batch(X: np.ndarray, centroids: np.ndarray):
    """Native batch nearest-centroid (no creation): each row's nearest
    centroid by float64 squared distance, the first of equal distances.
    Returns ``(idx [N] i64, d2 [N] f64)`` or None when the library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    X = np.ascontiguousarray(X, np.float32)
    C = np.ascontiguousarray(centroids, np.float64)
    n, f = X.shape
    idx = np.zeros(n, np.int64)
    d2 = np.zeros(n, np.float64)
    lib.mrs_nearest_centroid(X.ctypes.data, n, f, C.ctypes.data, len(C),
                             idx.ctypes.data, d2.ctypes.data)
    return idx, d2


def get_shard_lib():
    """The loaded shard-reader library, or None without g++."""
    global _shard_lib, _shard_tried
    with _lock:
        if _shard_lib is not None or _shard_tried:
            return _shard_lib
        _shard_tried = True
        lib = _load(shard_reader_spec(), "shard reader")
        if lib is None:
            return None
        lib.mrs_shard_reader_open_at.restype = ctypes.c_void_p
        lib.mrs_shard_reader_open_at.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.mrs_shard_reader_next.restype = ctypes.c_int64
        lib.mrs_shard_reader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.mrs_shard_reader_close.restype = None
        lib.mrs_shard_reader_close.argtypes = [ctypes.c_void_p]
        _shard_lib = lib
        return _shard_lib


class ShardReader:
    """Blocks of ``block_rows`` rows over raw shard files, in order; the
    last block may be shorter. The native reader reads block t + 1 from
    disk on its own thread while the caller uses block t; without it, a
    Python generator over ``np.memmap`` views yields the same blocks.
    ``start_row`` starts that many rows into the concatenated shards, by
    seeking: skipped files are not read."""

    def __init__(self, paths, block_rows: int, n_features: int,
                 start_row: int = 0, dtype=np.float32):
        self._handle = None
        if int(start_row) < 0:
            raise ValueError(f"start_row must be >= 0, got {start_row}")
        self.paths = [str(p) for p in paths]
        self.block_rows = int(block_rows)
        self.f = int(n_features)
        self.dtype = np.dtype(dtype)
        self.row_bytes = self.f * self.dtype.itemsize
        self.start_row = int(start_row)
        self._lib = get_shard_lib()
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
            self._handle = self._lib.mrs_shard_reader_open_at(
                arr, len(self.paths), self.block_rows, self.row_bytes, self.start_row)
        self._py_iter = None if self._handle else self._python_blocks()

    @property
    def native(self) -> bool:
        return self._lib is not None

    def _python_blocks(self):
        buf = np.empty((self.block_rows, self.f), self.dtype)
        fill = 0
        skip = self.start_row
        for p in self.paths:
            mm = np.memmap(p, dtype=self.dtype).reshape(-1, self.f)
            if skip >= len(mm):
                skip -= len(mm)
                continue
            pos, skip = skip, 0
            while pos < len(mm):
                take = min(self.block_rows - fill, len(mm) - pos)
                buf[fill : fill + take] = mm[pos : pos + take]
                fill += take
                pos += take
                if fill == self.block_rows:
                    yield buf.copy()
                    fill = 0
        if fill:
            yield buf[:fill].copy()

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is not None:
            out = np.empty((self.block_rows, self.f), self.dtype)
            rows = self.read_into(out)
            if rows == 0:
                raise StopIteration
            return out[:rows]
        if self._py_iter is None:          # the native stream ended: stay ended
            raise StopIteration
        return next(self._py_iter)

    def read_into(self, out: np.ndarray) -> int:
        """Copy the next block into the first rows of ``out`` (C-contiguous,
        the reader's type, room for ``block_rows`` rows: for example a
        pinned staging buffer, so the block is copied once on the host);
        returns its rows, 0 at the end of the stream."""
        if out.dtype != self.dtype or not out.flags.c_contiguous \
                or out.size < self.block_rows * self.f:
            raise ValueError(f"read_into needs a C-contiguous {self.dtype} buffer of "
                             f"{self.block_rows} x {self.f}")
        if self._handle is not None:
            rows = self._lib.mrs_shard_reader_next(self._handle, out.ctypes.data)
            if rows < 0:
                self.close()
                raise IOError("native shard reader IO error")
            if rows == 0:
                self.close()
            return int(rows)
        block = next(self, None)
        if block is None:
            return 0
        out.reshape(-1, self.f)[:len(block)] = block
        return len(block)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.mrs_shard_reader_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
