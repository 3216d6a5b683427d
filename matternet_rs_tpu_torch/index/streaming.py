"""Streaming index (twin of the reference's ``index/streaming.py``): one
card, a corpus on disk.

* build: stage-1 clustering on a strided row sample (the native scan), the
  F×F graph from the centroids, then one streamed pass that writes the raw
  λ of every row beside the shards (``lambdas.bin``) with the graph and the
  stats (``index.json``, ``graph.bin``). Crash-resumable; the files are the
  reference's byte for byte, so each package loads the other's store.
* search: ``[block_rows, F]`` blocks and their λ slices go host → card
  from pinned staging buffers while the native reader reads ahead; each
  block is scored and merged into a top-k carry that stays on the card.
* resident sketch: an int8 row-quantised copy of the corpus on the card,
  scanned per batch (the carry scan, or from ``MAXFIRST_MIN_ROWS`` flat
  rows the maxima-first scan through kernels D and E), then an exact
  rescore of the per-query candidates fetched from disk. Under a running
  ``torch.profiler`` :meth:`StreamingIndex.search_batch_sketch` records
  one span tree a call (:func:`..utils.profiling.span`).

Selection is exact everywhere: the reference's ``lax.approx_max_k`` in the
carry scan returns ``lax.top_k``'s values and ids off the TPU, ties lowest
index first, and :func:`..ops.search.topk_stable` gives those.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from matternet_rs_tpu_torch.backend import resolve_device
from matternet_rs_tpu_torch.core import TAUDEFAULT, TauMode
from matternet_rs_tpu_torch.graph import GraphLaplacian, GraphParams
from matternet_rs_tpu_torch.ops import scores as score_ops
from matternet_rs_tpu_torch.ops import search as search_ops
from matternet_rs_tpu_torch.ops import taumode as taumode_ops
from matternet_rs_tpu_torch.ops._mm import mm_bf16
from matternet_rs_tpu_torch.ops.kernels import energy_scan as esk
from matternet_rs_tpu_torch.ops.kernels import rescored as rsk
from matternet_rs_tpu_torch.ops.kernels.tilemax import blend
from matternet_rs_tpu_torch.ops.search import topk_stable
from matternet_rs_tpu_torch.storage import shards as shard_store
from matternet_rs_tpu_torch.utils import profiling

INDEX_FILE = "index.json"
LAMBDA_FILE = "lambdas.bin"
GRAPH_FILE = "graph.bin"
GRAPH_ELL_FILE = "graph_ell.npz"
ENERGY_FILE = "energy.npz"
SKETCH_FILE = "sketch.bin"            # int8 [N, F] row-quantized corpus
SKETCH_META_FILE = "sketch_meta.npz"  # per-row dequant multiplier

# Flat sketch rows from which sketch_maxfirst=None takes the maxima-first
# scan: the reference's crossover, kept so both packages route alike.
MAXFIRST_MIN_ROWS = 4_000_000
DEFAULT_BLOCK_ROWS = 131_072
# Blocks the streamed scan may have queued on the card (and staging
# buffers on the host) before it waits for the oldest.
FLIGHT_BLOCKS = 8


def _host_bf16(block: np.ndarray) -> torch.Tensor:
    """f32 → bf16 on the host (round to nearest even, as ``ml_dtypes``):
    halves the host → card bytes of a streamed block."""
    return torch.from_numpy(np.ascontiguousarray(block, np.float32)).to(torch.bfloat16)


def _masked(scores, valid: int, fill: float):
    """Columns ≥ ``valid`` set to ``fill``."""
    if valid < scores.shape[1]:
        scores = scores.clone()
        scores[:, valid:] = fill
    return scores


def _score_block_batch(X, lams, Q, q_lams, alpha, mn: float, rng: float, valid: int, k: int):
    """Blended top-k over one block (raw λ normalised here, rows ≥ ``valid``
    at -inf). f32 blocks take the full-f32 product the exact tier ranks
    with; bf16 blocks one bf16 pass summed in f32."""
    Xf = X.float()
    norms = torch.sqrt(torch.sum(Xf * Xf, dim=-1))
    qn = torch.sqrt(torch.sum(Q * Q, dim=-1))
    lam_n = score_ops.normalised(lams, mn, rng)
    scores = blend(search_ops._scan_dots_batch(X, Q), norms[None, :] * qn[:, None],
                   lam_n[None, :], q_lams[:, None], alpha)
    return topk_stable(_masked(scores, valid, -float("inf")), k)


def _energy_block_batch(X, lams, Q, q_lams, mn: float, rng: float, valid: int, k: int):
    """Energy-mode block scores, ascending: the reference's energymaps
    semantics streamed (:func:`..ops.kernels.energy_scan.energy_scores_plain`)."""
    norms = torch.sqrt(torch.sum(X * X, dim=-1))
    scores = esk.energy_scores_plain(X, norms, score_ops.normalised(lams, mn, rng), Q, q_lams)
    neg, idx = topk_stable(-_masked(scores, valid, float("inf")), k)
    return -neg, idx


def _merge_topk(best_s, best_i, sc, idx, offset: int, ascending: bool, kk: int):
    """The streamed carry: the carry sits left of the block's candidates
    and the sort is stable, so on exact ties the earlier (lower) id wins."""
    gids = torch.where(idx >= 0, idx + offset, -1)
    cat_s = torch.cat([best_s, sc], dim=1)
    cat_i = torch.cat([best_i, gids], dim=1)
    key = cat_s if ascending else -cat_s
    sel = torch.sort(key, dim=1, stable=True).indices[:, :kk]
    return torch.gather(cat_s, 1, sel), torch.gather(cat_i, 1, sel)


def scan_sketch_blocks(X8s, mults, lams, valids, Q, q_lams, alpha, mn: float, rng: float,
                       kk: int, offset0: int, energy: bool = False):
    """The carry scan over stacked ``[nb, blk, F]`` int8 blocks with a
    per-query top-``kk`` carry, global ids from ``offset0`` (0 on one card;
    a device's first row in the mesh-sharded sketch). Per block: one bf16
    product summed in f32 (int8 is exact in bf16), the dequantised cosine
    and the blend (or, ``energy=True``, the negated energy score, so the
    carry keeps the maximize convention), rows ≥ the block's valid count
    at -inf, an exact per-block top-min(kk, blk), the kk-wide merge.
    ``valids`` lives on the card: nothing is read back."""
    b = Q.shape[0]
    blk = X8s.shape[1]
    qn = score_ops.norm_floor(torch.sqrt(torch.sum(Q * Q, dim=-1)))[:, None]
    col = torch.arange(blk, device=Q.device)[None, :]
    kb = min(kk, blk)
    best_s = torch.full((b, kk), -float("inf"), dtype=torch.float32, device=Q.device)
    best_i = torch.full((b, kk), -1, dtype=torch.int64, device=Q.device)
    offset = torch.full((), offset0, dtype=torch.int64, device=Q.device)
    for i in range(X8s.shape[0]):
        dots = mm_bf16(Q, X8s[i].T)                                  # [B, blk]
        cos = score_ops.dequant_cosine(dots, mults[i][None, :], qn)
        lam_n = score_ops.normalised(lams[i], mn, rng)[None, :]
        if energy:
            scores = -score_ops.energy_score(torch.abs(lam_n - q_lams[:, None]), cos)
        else:
            scores = score_ops.blend(cos, lam_n, q_lams[:, None], alpha)
        valid = valids[i].to(torch.int64)
        scores = torch.where(col < valid, scores, -float("inf"))
        sc, idx = topk_stable(scores, kb)
        cat_s = torch.cat([best_s, sc], dim=1)
        cat_i = torch.cat([best_i, torch.where(sc > -float("inf"), idx + offset, -1)], dim=1)
        best_s, sel = topk_stable(cat_s, kk)
        best_i = torch.gather(cat_i, 1, sel)
        offset = offset + valid
    return best_s, best_i


def _sketch_scan_topk(X8s, mults, lams, valids, Q, q_lams, alpha, mn: float, rng: float,
                      kk: int, energy: bool = False):
    """The whole sketch's top-``kk`` on one card (:func:`scan_sketch_blocks`)."""
    return scan_sketch_blocks(X8s, mults, lams, valids, Q, q_lams, alpha, mn, rng, kk, 0,
                              energy=energy)


def suffix_padded(validh, blk: int) -> bool:
    """True when every block before the first partial one is full: the flat
    ``[nb·blk]`` row index is then the global id of every real row, the
    maxima-first scan's precondition (here and in the mesh-sharded sketch)."""
    partial_seen = False
    for v in np.asarray(validh).tolist():
        if partial_seen and v > 0:
            return False
        if v < blk:
            partial_seen = True
    return True


def _sketch_flatten(X8s, mults, lams, mn: float, rng: float):
    """Flat ``[nb·blk, F]`` int8 rows and ``[nb·blk]`` multipliers as views
    of the stacked sketch (no copy, F unpadded: the reference padded F to
    128 and kept a second resident buffer for Mosaic's DMA tiling; kernels
    D and E take any F), and the λ column normalised once."""
    nb, blk, f = X8s.shape
    lam_n = score_ops.normalised(lams.reshape(nb * blk), mn, rng)
    return X8s.view(nb * blk, f), mults.view(nb * blk), lam_n


def _sketch_maxfirst_topk(X8f, mult_f, lam_f, Q, q_lams, alphas, rows_out: int,
                          kfinal: int, n_items: int):
    """The maxima-first sketch scan: :func:`..ops.search.maxfirst_slabs`
    over the flat int8 rows (their multiplier as ``rn``, rows ≥ ``n_items``
    masked), the dequantised cosine and the blend at sketch precision, the
    top-``rows_out``. Returns ``(scores [B, R], ids [B, R])`` on the card,
    ids -1 where the score is -inf. The caller checks
    :meth:`StreamingIndex._sketch_fused_ok`."""
    d, mult_s, lam_s, gidx = search_ops.maxfirst_slabs(
        X8f, X8f, mult_f, lam_f, Q, q_lams, alphas, kfinal, rows_out, search_ops.DEFAULT_TILE,
        mult_f, n_items, rsk.tilemax_only, search_ops._slab_dots_checked)
    qn = torch.sqrt(torch.sum(Q * Q, dim=-1))
    cos = score_ops.dequant_cosine(d, mult_s, score_ops.norm_floor(qn)[:, None, None])
    s = score_ops.blend(cos, lam_s, q_lams[:, None, None], alphas[:, None, None]).flatten(1)
    s = torch.where(gidx < n_items, s, -float("inf"))
    top, pos = topk_stable(s, min(rows_out, gidx.shape[1]))
    return top, torch.where(top > -float("inf"), torch.gather(gidx, 1, pos), -1)


def _refine_exact_topk(XU, lamU, Q, q_lams, alpha, mn: float, rng: float, valid_u: int, kk: int):
    """Exact blended rescore of the fetched union (the full-f32 product of
    the exact scan), top-``kk`` in union positions."""
    return _score_block_batch(XU, lamU, Q, q_lams, alpha, mn, rng, valid_u, kk)


def _refine_energy_topk(XU, lamU, Q, q_lams, mn: float, rng: float, valid_u: int, kk: int):
    """Exact energy-mode rescore of the fetched union."""
    return _energy_block_batch(XU, lamU, Q, q_lams, mn, rng, valid_u, kk)


def _quantize_rows(block: np.ndarray):
    """Per-row symmetric int8 on the host: ``q8 = rint(x/scale)``,
    ``scale = maxabs/127``; ``mult`` turns a raw int8 dot into the cosine
    numerator over |x| (zero rows: 0, the guarded-cosine convention)."""
    maxabs = np.abs(block).max(axis=1)
    norms = np.sqrt(np.sum(block.astype(np.float64) ** 2, axis=1)).astype(np.float32)
    scale = np.where(maxabs > 0, maxabs / 127.0, 1.0).astype(np.float32)
    q8 = np.rint(block / scale[:, None]).astype(np.int8)
    mult = np.where(norms > 1e-12, scale / np.maximum(norms, 1e-12), 0.0)
    return q8, mult.astype(np.float32)


def _publish_sketch_files(directory: Path, sk_tmp: Path, mult: np.ndarray):
    """Publish the sketch pair from a fully written int8 tmp file. The meta
    file is the commit point and goes first, so a crash leaves the old
    pair or a missing meta (readers rebuild), never a new sketch with an
    old meta. Not safe against two concurrent writers."""
    meta = directory / SKETCH_META_FILE
    m_tmp = directory / (SKETCH_META_FILE + ".tmp")
    try:
        with m_tmp.open("wb") as mfh:
            np.savez(mfh, mult=np.ascontiguousarray(mult, np.float32))
        meta.unlink(missing_ok=True)
        os.replace(sk_tmp, directory / SKETCH_FILE)
        os.replace(m_tmp, meta)
    finally:
        m_tmp.unlink(missing_ok=True)


def _staging(shape, dtype, device):
    """A host buffer for copies to ``device``: pinned for a card, so the
    copy runs asynchronously."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


@dataclasses.dataclass
class StreamingIndex:
    directory: Path
    gl: GraphLaplacian
    taumode: TauMode
    min_lambdas: float
    range_lambdas: float
    n_items: int
    n_features: int
    block_rows: int = DEFAULT_BLOCK_ROWS
    # Energy-mode state (an energy-built store): queries take the nearest
    # sub-centroid's λ, on the host.
    sub_centroids: Optional[np.ndarray] = None
    subcentroid_lambdas: Optional[np.ndarray] = None
    # JL projection metadata: query λ is prepared in the reduced space;
    # corpus scoring stays original-dim.
    projection: Optional[object] = None
    # Seconds per build stage (build_from_store; not persisted).
    build_timings: Optional[dict] = None
    # The stage-1 scan's assignment of each sampled row (-1: dropped), as
    # build_from_store left it (not persisted).
    cluster_assignments: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)
    # Where the graph, the streamed blocks and the sketch live (None: the
    # CUDA card, resolved at use).
    device: Optional[torch.device] = dataclasses.field(default=None, compare=False)
    # Resident int8 sketch (build_sketch): (X8s [nb, blk, F] int8, mults
    # [nb, blk], raw λ [nb, blk], valids [nb] int32) on the device.
    _sketch: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)
    # Flat views + normalised λ for the maxima-first scan (lazy).
    _sketch_flat: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)
    # Guards the lazy flat views and the refine's maps: two serving workers
    # may race the first batch; the normalised λ column is made once.
    _sketch_flat_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )
    _sketch_suffix_pad: bool = dataclasses.field(default=False, repr=False, compare=False)
    # The refine's read-only maps of the store's rows and λ, opened at first
    # use and kept, so a batch faults in only pages no batch read before.
    _refine_maps: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)
    # Maxima-first sketch scan: None = from MAXFIRST_MIN_ROWS flat rows
    # (the reference's measured crossover); True/False force it.
    sketch_maxfirst: Optional[bool] = dataclasses.field(default=None, repr=False, compare=False)

    # The lock and the maps are per-process state: left out of pickles and copies.
    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_sketch_flat_lock", None)
        state["_refine_maps"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._sketch_flat_lock = threading.Lock()

    def _dev(self) -> torch.device:
        return resolve_device(self.device)

    def _taumode_graph(self, f: int):
        """The graph λ is taken against: ELL for an ELL-backed graph or past
        the sparse threshold, else the dense matrix."""
        gl = self.gl
        if gl.is_ell_backed or f > taumode_ops.SPARSE_F_THRESHOLD:
            return gl.ell()
        return gl.matrix

    # ------------------------------------------------------------------
    @classmethod
    def build_from_store(
        cls,
        directory,
        graph_params: GraphParams,
        max_clusters: int,
        radius: float,
        taumode: TauMode = TAUDEFAULT,
        block_rows: int = DEFAULT_BLOCK_ROWS,
        sample_rows: int = 200_000,
        seed: int = 0,
        resume: bool = False,
        emit_sketch: bool = False,
        device=None,
    ) -> "StreamingIndex":
        """Two streamed passes over the store: (1) strided row sample →
        incremental clustering → F×F graph; (2) raw λ of every row,
        appended to ``lambdas.bin``, stats in ``index.json``.

        Crash-resumable: the graph is saved before the λ pass, each block
        is appended as it completes, ``resume=True`` continues after the
        last whole block (a torn tail is cut by its byte count; a complete
        file is a no-op). ``emit_sketch=True`` writes ``sketch.bin`` and
        ``sketch_meta.npz`` during the λ pass (not when resuming past block
        0). Block i's λ is read back and written while block i + 1's
        upload and λ run on ``device`` (None: the CUDA card)."""
        from matternet_rs_tpu_torch.clustering import incremental_clustering
        from matternet_rs_tpu_torch.ops import laplacian as lap_ops

        dev = resolve_device(device)
        t_start = time.perf_counter()
        directory = Path(directory)
        m = shard_store.read_manifest(directory)
        n, f = m["n_rows"], m["n_features"]
        lam_path = directory / LAMBDA_FILE
        meta_path = directory / INDEX_FILE

        idx = None
        if resume and meta_path.exists():
            idx = cls.load(directory, device=dev)
            if idx.n_items != n or idx.n_features != f or idx.block_rows != block_rows:
                idx = None                 # the store changed: rebuild
            else:
                taumode = idx.taumode      # the checkpointed τ policy wins

        if idx is None:
            stride = max(1, n // max(sample_rows, 1))
            sample: list[np.ndarray] = []
            offset = 0
            reader = shard_store.stream_blocks(directory, block_rows)
            try:
                for block in reader:
                    first = (-offset) % stride
                    sample.append(block[first::stride])
                    offset += len(block)
            finally:
                reader.close()
            Xs = np.concatenate(sample)[:sample_rows]
            out = incremental_clustering(Xs, max_clusters, radius)
            gl = lap_ops.build_laplacian_from_k_cluster(
                torch.from_numpy(out.centroids).to(dev), graph_params, n_items=n
            )
            idx = cls(directory=directory, gl=gl, taumode=taumode,
                      min_lambdas=float("nan"), range_lambdas=float("nan"),
                      n_items=n, n_features=f, block_rows=block_rows, device=dev,
                      cluster_assignments=out.assignments)
            # The stale λ file (and sketch) go BEFORE the new checkpoint
            # exists: a new meta must never point at old λ rows.
            lam_path.unlink(missing_ok=True)
            (directory / SKETCH_FILE).unlink(missing_ok=True)
            (directory / SKETCH_META_FILE).unlink(missing_ok=True)
            idx._save_meta()

        done_rows = 0
        mn, mx = np.inf, -np.inf
        if resume and lam_path.exists():
            have_bytes = lam_path.stat().st_size
            have = have_bytes // 4
            done_rows = n if have >= n else (have // block_rows) * block_rows
            # Bytes, not floats: a torn write may leave 1-3 stray bytes.
            if have_bytes != done_rows * 4:
                with open(lam_path, "r+b") as fh:
                    fh.truncate(done_rows * 4)
            if done_rows:
                prev = np.memmap(lam_path, np.float32, "r", shape=(done_rows,))
                mn, mx = float(prev.min()), float(prev.max())

        t_pass1 = time.perf_counter()
        graph = idx._taumode_graph(f)
        sk_tmp = directory / (SKETCH_FILE + ".tmp")
        emit = emit_sketch and done_rows == 0
        if emit:
            sk_tmp.unlink(missing_ok=True)
        sk_fh = open(sk_tmp, "wb") if emit else None
        mult_all = np.zeros(n, np.float32) if emit else None
        # Two staging slots each way: block i + 1 fills the other slot
        # while block i's copies are in flight.
        x_stage = [_staging((block_rows, f), torch.float32, dev) for _ in range(2)]
        l_stage = [_staging((block_rows,), torch.float32, dev) for _ in range(2)]
        pending = None                     # (slot, rows, event) of the block in flight
        offset = done_rows
        try:
            with open(lam_path, "ab") as fh:

                def _drain(p) -> None:
                    nonlocal mn, mx
                    slot, rows, ev = p
                    if ev is not None:
                        ev.synchronize()
                    raw = l_stage[slot].numpy()[:rows]
                    mn = min(mn, float(raw.min()))
                    mx = max(mx, float(raw.max()))
                    fh.write(raw.tobytes())
                    fh.flush()

                reader = shard_store.stream_blocks(directory, block_rows, start_row=done_rows)
                try:
                    slot = 0
                    while True:
                        xs = x_stage[slot]
                        rows = reader.read_into(xs.numpy())
                        if rows == 0:
                            break
                        xd = xs[:rows].to(dev, non_blocking=True)
                        lam = taumode_ops.taumode_lambdas_auto(xd, graph, taumode.mode, taumode.param)
                        l_stage[slot][:rows].copy_(lam, non_blocking=True)
                        ev = None
                        if dev.type == "cuda":
                            ev = torch.cuda.Event()
                            ev.record()
                        if sk_fh is not None:
                            # The block is in host memory: the sketch costs
                            # no corpus IO, and runs while λ runs.
                            q8, mult = _quantize_rows(xs.numpy()[:rows])
                            sk_fh.write(q8.tobytes())
                            mult_all[offset:offset + rows] = mult
                        if pending is not None:
                            _drain(pending)
                        pending = (slot, rows, ev)
                        offset += rows
                        slot ^= 1
                    if pending is not None:
                        _drain(pending)
                finally:
                    reader.close()
            if sk_fh is not None:
                sk_fh.close()
                sk_fh = None
                _publish_sketch_files(directory, sk_tmp, mult_all)
        finally:
            if sk_fh is not None:
                sk_fh.close()
            if emit:
                sk_tmp.unlink(missing_ok=True)
        idx.min_lambdas = mn
        idx.range_lambdas = (mx - mn) if mx > mn else 1.0
        idx._save_meta()
        idx.build_timings = {
            "sample_cluster_graph_s": round(t_pass1 - t_start, 3),
            "lambda_pass_s": round(time.perf_counter() - t_pass1, 3),
            "lambda_rows_computed": int(offset - done_rows),
        }
        return idx

    def _save_meta(self) -> None:
        """Atomic checkpoint: the graph as raw f32 ``graph.bin`` (or the ELL
        arrays), metadata as strict JSON (unfinished stats as null), each
        by write-tmp + rename."""
        if self.gl.is_ell_backed:
            e = self.gl.ell()
            g_tmp = self.directory / (GRAPH_ELL_FILE + ".tmp")
            with g_tmp.open("wb") as fh:
                np.savez(
                    fh,
                    indices=e.indices.cpu().numpy().astype(np.int32),
                    weights=e.weights.cpu().numpy().astype(np.float32),
                    diag=e.diag.cpu().numpy().astype(np.float32),
                )
            os.replace(g_tmp, self.directory / GRAPH_ELL_FILE)
            g_shape = list(e.shape)
        else:
            G = np.ascontiguousarray(self.gl.matrix.cpu().numpy(), np.float32)
            g_tmp = self.directory / (GRAPH_FILE + ".tmp")
            g_tmp.write_bytes(G.tobytes())
            os.replace(g_tmp, self.directory / GRAPH_FILE)
            g_shape = list(G.shape)

        def _num(v):
            return float(v) if np.isfinite(v) else None

        if self.sub_centroids is not None:
            e_tmp = self.directory / (ENERGY_FILE + ".tmp")
            with e_tmp.open("wb") as fh:       # closed before the rename
                np.savez(
                    fh,
                    sub_centroids=np.asarray(self.sub_centroids, np.float32),
                    subcentroid_lambdas=np.asarray(self.subcentroid_lambdas, np.float32),
                )
            os.replace(e_tmp, self.directory / ENERGY_FILE)

        meta = {
            "min_lambdas": _num(self.min_lambdas),
            "range_lambdas": _num(self.range_lambdas),
            "n_items": self.n_items,
            "n_features": self.n_features,
            "block_rows": self.block_rows,
            "taumode": {"mode": int(self.taumode.mode), "param": float(self.taumode.param)},
            "graph_params": dataclasses.asdict(self.gl.graph_params),
            "graph_nnodes": self.gl.nnodes,
            "graph_shape": g_shape,
            "graph_format": "ell" if self.gl.is_ell_backed else "dense",
            "energy_mode": self.sub_centroids is not None,
            "projection": (
                None if self.projection is None else {
                    "seed": int(self.projection.seed),
                    "original_dim": int(self.projection.original_dim),
                    "reduced_dim": int(self.projection.reduced_dim),
                }
            ),
        }
        m_tmp = self.directory / (INDEX_FILE + ".tmp")
        m_tmp.write_text(json.dumps(meta, allow_nan=False))
        os.replace(m_tmp, self.directory / INDEX_FILE)

    @classmethod
    def load(cls, directory, device=None) -> "StreamingIndex":
        """Open a store from ``index.json``, the graph and ``lambdas.bin``
        (no recompute); the graph goes to ``device`` (None: the CUDA card)."""
        from matternet_rs_tpu_torch.ops.csr import EllLaplacian
        from matternet_rs_tpu_torch.reduction import ImplicitProjection

        dev = resolve_device(device)
        directory = Path(directory)
        meta = json.loads((directory / INDEX_FILE).read_text())
        params = GraphParams(**meta["graph_params"])
        shape = tuple(meta["graph_shape"])
        if meta.get("graph_format") == "ell":
            with np.load(directory / GRAPH_ELL_FILE) as gz:
                ell = EllLaplacian(
                    indices=torch.from_numpy(np.asarray(gz["indices"], np.int32)).to(dev),
                    weights=torch.from_numpy(np.asarray(gz["weights"], np.float32)).to(dev),
                    diag=torch.from_numpy(np.asarray(gz["diag"], np.float32)).to(dev),
                )
            gl = GraphLaplacian.from_ell(ell, init_data=ell.weights, nnodes=meta["graph_nnodes"],
                                         graph_params=params)
        else:
            matrix = torch.from_numpy(
                np.frombuffer((directory / GRAPH_FILE).read_bytes(), np.float32).reshape(shape).copy()
            ).to(dev)
            gl = GraphLaplacian(matrix=matrix, init_data=matrix, nnodes=meta["graph_nnodes"],
                                graph_params=params)

        def _num(v):
            return float("nan") if v is None else float(v)

        sub_c = sc_lam = None
        if meta.get("energy_mode"):
            with np.load(directory / ENERGY_FILE) as ez:
                sub_c = ez["sub_centroids"]
                sc_lam = ez["subcentroid_lambdas"]
        proj = None
        if meta.get("projection"):
            pj = meta["projection"]
            proj = ImplicitProjection(pj["original_dim"], pj["reduced_dim"], pj["seed"])
        return cls(
            directory=directory, gl=gl,
            taumode=TauMode(meta["taumode"]["mode"], meta["taumode"]["param"]),
            min_lambdas=_num(meta["min_lambdas"]), range_lambdas=_num(meta["range_lambdas"]),
            n_items=meta["n_items"], n_features=meta["n_features"], block_rows=meta["block_rows"],
            sub_centroids=sub_c, subcentroid_lambdas=sc_lam, projection=proj, device=dev,
        )

    # ------------------------------------------------------------------
    def _queries(self, queries) -> torch.Tensor:
        """``[B, F]`` float32 queries on the index's device (a tensor
        already there is not copied)."""
        Q = torch.as_tensor(queries, dtype=torch.float32, device=self._dev())
        if Q.ndim == 1:
            Q = Q[None, :]
        if Q.shape[-1] != self.n_features:
            raise ValueError(
                f"Query dimension {Q.shape[-1]} doesn't match index dimension {self.n_features}"
            )
        return Q

    def _reduced_query(self, q: torch.Tensor) -> torch.Tensor:
        """Projected to the λ space when a JL projection is active."""
        if self.projection is not None and q.shape[-1] == self.projection.original_dim:
            return self.projection.project(q)
        return q

    def prepare_query_lambda(self, query) -> float:
        return float(self._query_lambdas(self._queries(query))[0])

    def _lambda_blocks(self):
        lam = np.memmap(self.directory / LAMBDA_FILE, np.float32, "r", shape=(self.n_items,))
        for start in range(0, self.n_items, self.block_rows):
            yield lam[start:start + self.block_rows]

    def _query_lambdas(self, Q: torch.Tensor) -> torch.Tensor:
        """Normalised query λ ``[B]`` on Q's device: energy mode takes the
        nearest sub-centroid's λ (on the host, as the reference), eigen
        mode the taumode graph's."""
        if self.sub_centroids is not None:
            Qr = self._reduced_query(Q).cpu().numpy()
            dd = ((Qr[:, None, :] - self.sub_centroids[None, :, :]) ** 2).sum(-1)
            lam = np.asarray(self.subcentroid_lambdas, np.float32)[dd.argmin(1)]
            return torch.from_numpy(lam).to(Q.device)
        Qr = self._reduced_query(Q)
        return taumode_ops.query_lambdas(Qr, self._taumode_graph(Qr.shape[-1]),
                                         self.taumode.mode, self.taumode.param,
                                         self.min_lambdas, self.range_lambdas)[1]

    def _stream_topk(self, kernel, b: int, k: int, ascending: bool, quantized: bool = False):
        """The streamed top-k: each block (padded to ``block_rows``) through
        ``kernel(block, lam_slice, valid)``, merged into a carry that stays
        on the device; the only device → host copy is the final ``[b, k]``.
        Blocks are read by the native reader straight into pinned staging
        slots and copied to the card asynchronously, so reading, copying
        and scoring overlap; before a slot is reused the host waits on the
        event recorded after that block's merge, which also bounds the
        blocks in flight to ``FLIGHT_BLOCKS``."""
        dev = self._dev()
        f, blk = self.n_features, self.block_rows
        kk = min(k, self.n_items)
        fill = float("inf") if ascending else -float("inf")
        best_s = torch.full((b, kk), fill, dtype=torch.float32, device=dev)
        best_i = torch.full((b, kk), -1, dtype=torch.int64, device=dev)
        nslots = FLIGHT_BLOCKS if dev.type == "cuda" else 1
        x_stage = [_staging((blk, f), torch.float32, dev) for _ in range(nslots)]
        b_stage = [_staging((blk, f), torch.bfloat16, dev) for _ in range(nslots)] if quantized else None
        l_stage = [_staging((blk,), torch.float32, dev) for _ in range(nslots)]
        done = [None] * nslots
        offset = 0
        reader = shard_store.stream_blocks(self.directory, blk)
        lam_blocks = self._lambda_blocks()
        try:
            for i, lam in enumerate(lam_blocks):
                s = i % nslots
                if done[s] is not None:
                    done[s].synchronize()
                xs = x_stage[s]
                valid = reader.read_into(xs.numpy())
                if valid == 0:
                    break
                if valid < blk:                      # pad the tail to the fixed shape
                    xs[valid:] = 0.0
                ls = l_stage[s]
                ls.numpy()[:valid] = lam
                ls[valid:] = 0.0
                if quantized:
                    b_stage[s].copy_(_host_bf16(xs.numpy()))
                    xs = b_stage[s]
                sc, idx = kernel(xs.to(dev, non_blocking=True), ls.to(dev, non_blocking=True), valid)
                best_s, best_i = _merge_topk(best_s, best_i, sc, idx, offset, ascending, kk)
                offset += valid
                if dev.type == "cuda":
                    done[s] = torch.cuda.Event()
                    done[s].record()
        finally:
            reader.close()
        return best_i.cpu().numpy().astype(np.int64), best_s.cpu().numpy()

    def search(self, query, k: int, alpha: float = 0.7,
               quantized: bool = False) -> list[tuple[int, float]]:
        """Streamed exact blended top-k; ``quantized=True`` ships each block
        as bf16 (half the host → card bytes, bf16 ranking fidelity)."""
        idx, sc = self.search_batch(np.asarray(query, np.float32)[None, :], k, alpha,
                                    quantized=quantized)
        return [(int(i), float(s)) for i, s in zip(idx[0], sc[0]) if i >= 0]

    def search_batch(self, queries, k: int, alpha: float = 0.7, quantized: bool = False):
        """Batched streamed top-k. Returns ``(indices [B, k], scores [B, k])``."""
        Q = self._queries(queries)
        q_lams = self._query_lambdas(Q)
        al = score_ops.alpha_param(alpha, Q.shape[0], Q.device)
        kb = min(min(k, self.n_items), self.block_rows)
        mn, rng = float(self.min_lambdas), float(self.range_lambdas)

        def kernel(Xb, lamb, valid):
            return _score_block_batch(Xb, lamb, Q, q_lams, al, mn, rng, valid, kb)

        return self._stream_topk(kernel, Q.shape[0], k, ascending=False, quantized=quantized)

    # ------------------------------------------------------------------
    # The resident sketch: one pass uploads an int8 row-quantised copy
    # (N·(F + 8) bytes), every batch scans it on the card, and only the
    # per-query candidates are fetched from disk for an exact rescore.
    # ------------------------------------------------------------------
    def sketch_host_buffers(self, persist: bool = True, force: bool = False,
                            nb_pad: int | None = None):
        """The stacked sketch on the host, ``(X8 [nb, blk, F] int8, mult
        [nb, blk], lam [nb, blk], valid [nb])``: reloaded from
        ``sketch.bin`` through the native reader (``dtype=int8``) when the
        pair is there, else quantised from the store (and, with
        ``persist``, published). ``nb_pad`` allocates that many blocks (the
        trailing ones zero with ``valid = 0``), so a sharded caller needs
        no second copy."""
        from matternet_rs_tpu_torch.native import ShardReader

        sk_path = self.directory / SKETCH_FILE
        meta_path = self.directory / SKETCH_META_FILE
        n, f, blk = self.n_items, self.n_features, self.block_rows
        nb = (n + blk - 1) // blk
        nb_alloc = max(nb, nb_pad or 0)
        X8h = np.zeros((nb_alloc, blk, f), np.int8)
        multh = np.zeros((nb_alloc, blk), np.float32)
        lamh = np.zeros((nb_alloc, blk), np.float32)
        validh = np.zeros(nb_alloc, np.int32)

        def _fill(i, q8, mult, lam, valid):
            X8h[i, :valid] = q8[:valid]
            multh[i, :valid] = mult[:valid]
            lamh[i, :valid] = lam[:valid]
            validh[i] = valid

        if sk_path.exists() and meta_path.exists() and not force:
            with np.load(meta_path) as z:
                mult_all = np.asarray(z["mult"], np.float32)
            reader = ShardReader([sk_path], blk, f, dtype=np.int8)
            try:
                start = 0
                for i, lam in enumerate(self._lambda_blocks()):
                    valid = reader.read_into(X8h[i])       # straight into the stacked buffer
                    stop = start + valid
                    multh[i, :valid] = mult_all[start:stop]
                    lamh[i, :valid] = lam[:valid]
                    validh[i] = valid
                    start = stop
            finally:
                reader.close()
        else:
            tmp = self.directory / (SKETCH_FILE + ".tmp")
            fh = open(tmp, "wb") if persist else None
            try:
                reader = shard_store.stream_blocks(self.directory, blk)
                try:
                    for i, (block, lam) in enumerate(zip(reader, self._lambda_blocks())):
                        q8, mult = _quantize_rows(np.asarray(block, np.float32))
                        if fh is not None:
                            fh.write(q8.tobytes())
                        _fill(i, q8, mult, np.asarray(lam), len(block))
                finally:
                    reader.close()
                if fh is not None:
                    fh.close()
                    fh = None
                    _publish_sketch_files(self.directory, tmp, multh.reshape(-1)[:n])
            finally:
                if fh is not None:
                    fh.close()
                tmp.unlink(missing_ok=True)
        return X8h, multh, lamh, validh

    def build_sketch(self, persist: bool = True, force: bool = False, device=None):
        """Quantise the store into a resident int8 sketch on ``device``
        (None: the index's device), one transfer per stacked array; with
        ``persist`` also write ``sketch.bin`` + ``sketch_meta.npz`` so a
        later session uploads from the 1-byte file. Returns (and caches)
        ``(X8s, mults, lams, valids)``."""
        if device is not None:
            self.device = resolve_device(device)
        dev = self._dev()
        X8h, multh, lamh, validh = self.sketch_host_buffers(persist=persist, force=force)
        with self._sketch_flat_lock:
            self._sketch = tuple(torch.from_numpy(a).to(dev) for a in (X8h, multh, lamh, validh))
            self._sketch_flat = None
            self._sketch_suffix_pad = suffix_padded(validh, X8h.shape[1])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return self._sketch

    def _sketch_fused_ok(self, b_pad: int, kk: int, cand: int) -> bool:
        """Whether the maxima-first scan takes the batch, decided as the
        reference decides it: suffix-only padding, a tile-divisible flat
        length, the ``MAXFIRST_MIN_ROWS`` crossover for
        ``sketch_maxfirst=None``, the reference's 4 GiB guard with F padded
        to 128 as it reckons it, and the rescored-path predicate at its
        padded batch ``b_pad``. (The port's flat views are views and the
        launch takes the real B; the predicate is kept so that both
        packages route the same shapes alike.)"""
        if self.sketch_maxfirst is False:
            return False
        if self._sketch is None or not self._sketch_suffix_pad:
            return False
        nb, blk, f = self._sketch[0].shape
        n = nb * blk
        if self.sketch_maxfirst is None and n < MAXFIRST_MIN_ROWS:
            return False
        f_pad = -(-f // 128) * 128
        if n * f_pad > 4 * 1024**3:
            return False
        return n % search_ops.DEFAULT_TILE == 0 and search_ops.fused_rescored_path(
            n, f_pad, b_pad, kk, cand
        )

    def _sketch_flat_views(self):
        flat = self._sketch_flat          # lock-free fast path (one read)
        if flat is not None:
            return flat
        with self._sketch_flat_lock:
            if self._sketch_flat is None:
                X8s, mults, lams, _ = self._sketch
                self._sketch_flat = _sketch_flatten(X8s, mults, lams, float(self.min_lambdas),
                                                    float(self.range_lambdas))
            return self._sketch_flat

    def _candidate_width(self, k: int, candidates: int | None) -> tuple[int, int]:
        """``(kk, C)``: the final k and the candidates the scan returns."""
        kk = min(k, self.n_items)
        C = min(candidates if candidates is not None else max(4 * k, 32),
                self.n_items, self.block_rows)
        return kk, max(C, kk)

    def _sketch_maxfirst_route(self, b: int, kk: int, C: int) -> bool:
        """Whether a batch of ``b`` queries takes the maxima-first scan:
        :meth:`_sketch_fused_ok` at the reference's padded batch."""
        return self._sketch_fused_ok(max(8, 1 << max(b - 1, 1).bit_length()), kk, C)

    def _sketch_candidates(self, Q: torch.Tensor, q_lams: torch.Tensor, kk: int, C: int, alpha=0.7):
        """The sketch scan on the card: ``(scores [B, C], ids [B, C])``,
        both on the device; maxima-first where :meth:`_sketch_maxfirst_route`
        holds, else the carry scan. No device → host read."""
        if self._sketch is None:
            self.build_sketch()
        b = Q.shape[0]
        al = score_ops.alpha_param(alpha, b, Q.device)      # a vector's length checked
        if self._sketch_maxfirst_route(b, kk, C):
            X8f, mult_f, lam_f = self._sketch_flat_views()
            return _sketch_maxfirst_topk(X8f, mult_f, lam_f, Q, q_lams,
                                         score_ops.alpha_vector(al, b, Q.device),
                                         rows_out=C, kfinal=kk, n_items=self.n_items)
        X8s, mults, lams, valids = self._sketch
        return _sketch_scan_topk(X8s, mults, lams, valids, Q, q_lams, al, float(self.min_lambdas),
                                 float(self.range_lambdas), kk=C)

    def search_batch_sketch(self, queries, k: int, alpha: float = 0.7,
                            candidates: int | None = None, refine: bool = True):
        """Resident int8 sketch scan → disk fetch of each query's top
        ``candidates`` → exact f32 rescore of the candidate union. Returns
        ``(ids [B, kk], scores [B, kk])`` like :meth:`search_batch`.
        ``refine=False`` serves the scan's first ``k`` columns (scores at
        sketch precision) and downloads only ``[B, k]``; otherwise only the
        ``[B, C]`` ids come back before the fetch.

        Under a running ``torch.profiler`` the call records the spans
        ``search.batch`` (attrs ``mode="sketch"``, ``route`` ``maxfirst``
        or ``carry``, ``b``, ``k``, ``cand``) and within it
        ``search.input``, ``search.query_lambda``, ``search.scan``,
        ``search.fetch`` (the ids to the host: the wait for the scan) and,
        refined, ``search.refine`` (attrs ``rows``, the union's size, and
        ``bytes`` read from the store) with its children ``refine.read``
        (the union's rows and λ from disk, on the host) and
        ``refine.rescore`` (the upload, the exact rescore and its top-k,
        the result to the host); each host–device sync counts against the
        span it falls in. A first call's lazy :meth:`build_sketch` stays
        outside the tree."""
        if self._sketch is None:
            self.build_sketch()
        dev = self._dev()
        with profiling.span("search.batch", mode="sketch", k=k) as root:
            with profiling.span("search.input"):
                if not isinstance(queries, torch.Tensor) or queries.device.type == "cpu":
                    profiling.count_sync(dev)         # host rows copied to the device
                Q = self._queries(queries)
                kk, C = self._candidate_width(k, candidates)
            maxfirst = self._sketch_maxfirst_route(Q.shape[0], kk, C)
            root.set(route="maxfirst" if maxfirst else "carry", b=Q.shape[0], cand=C)
            with profiling.span("search.query_lambda"):
                q_lams = self._query_lambdas(Q)
            with profiling.span("search.scan"):
                best_s, best_i = self._sketch_candidates(Q, q_lams, kk, C, alpha)
            if not refine:
                with profiling.span("search.fetch"):
                    return (profiling.to_host(best_i[:, :kk]).numpy().astype(np.int64),
                            profiling.to_host(best_s[:, :kk]).numpy())
            with profiling.span("search.fetch"):
                ids = profiling.to_host(best_i).numpy()
            with profiling.span("search.refine") as sp:
                with profiling.span("refine.read"):
                    union = self._fetch_union(ids, kk)
                u = union[3]
                sp.set(rows=u, bytes=u * self.n_features * 4)
                with profiling.span("refine.rescore"):
                    return self._rescore_union(ids, union, kk, self._exact_rescore(
                        Q, q_lams, score_ops.alpha_param(alpha, Q.shape[0], Q.device),
                        float(self.min_lambdas), float(self.range_lambdas), kk), -np.inf)

    def _store_maps(self):
        """``(RowReader, λ map)`` of the store for the refine, made once."""
        maps = self._refine_maps
        if maps is None:
            with self._sketch_flat_lock:
                if self._refine_maps is None:
                    self._refine_maps = (
                        shard_store.RowReader(self.directory),
                        np.memmap(self.directory / LAMBDA_FILE, np.float32, "r",
                                  shape=(self.n_items,)))
                maps = self._refine_maps
        return maps

    def _fetch_union(self, ids: np.ndarray, kk: int):
        """The candidate union for the refine stage: unique ids → the rows
        and λ through the kept maps (:meth:`_store_maps`), padded to at
        least ``kk`` rows (the reference padded to a power of two for its
        compiler; the padding is masked either way)."""
        uids = np.unique(ids[ids >= 0])
        rows, lam_mm = self._store_maps()
        XU = rows.rows(uids)
        lamU = np.asarray(lam_mm[uids], np.float32)
        u = len(uids)
        if u < kk:
            XU = np.concatenate([XU, np.zeros((kk - u, self.n_features), np.float32)])
            lamU = np.concatenate([lamU, np.zeros(kk - u, np.float32)])
        return uids, XU, lamU, u

    def _rescore_union(self, ids: np.ndarray, union, kk: int, rescore, miss: float):
        """``rescore(XU, lamU, u)`` of a fetched union on the device, union
        positions mapped back to global ids."""
        uids, XU, lamU, u = union
        if u == 0:                         # every id -1: all-miss rows
            return (np.full((ids.shape[0], kk), -1, np.int64),
                    np.full((ids.shape[0], kk), miss, np.float32))
        dev = self._dev()
        sc, sel = rescore(profiling.to_device(torch.from_numpy(XU), dev),
                          profiling.to_device(torch.from_numpy(lamU), dev), u)
        sel, sc = profiling.to_host(sel).numpy(), profiling.to_host(sc).numpy()
        hit = sc < np.inf if miss > 0 else sc > -np.inf
        return np.where(hit, uids[np.minimum(sel, u - 1)], -1).astype(np.int64), sc

    def _refine(self, ids, kk: int, rescore, miss: float):
        """Fetch the union of ``ids [B, C]``, ``rescore(XU, lamU, u)`` on
        the device, and map union positions back to global ids."""
        ids = np.asarray(ids)
        return self._rescore_union(ids, self._fetch_union(ids, kk), kk, rescore, miss)

    @staticmethod
    def _exact_rescore(Q, q_lams, al, mn: float, rng: float, kk: int):
        return lambda XU, lamU, u: _refine_exact_topk(XU, lamU, Q, q_lams, al, mn, rng, u, kk)

    def refine_candidates(self, ids, Q, q_lams, al, mn: float, rng: float, kk: int):
        """Exact rescore of a ``[B, C]`` candidate-id matrix (shared with
        the mesh-sharded sketch): ``(ids [B, kk] int64, scores)``."""
        return self._refine(ids, kk, self._exact_rescore(Q, q_lams, al, float(mn), float(rng), kk),
                            -np.inf)

    def search_sketch(self, query, k: int, alpha: float = 0.7, candidates: int | None = None,
                      refine: bool = True) -> list[tuple[int, float]]:
        """One query through :meth:`search_batch_sketch`."""
        idx, sc = self.search_batch_sketch(np.asarray(query, np.float32)[None, :], k, alpha,
                                           candidates=candidates, refine=refine)
        return [(int(i), float(s)) for i, s in zip(idx[0], sc[0]) if i >= 0]

    def search_energy_batch_sketch(self, queries, k: int, candidates: int | None = None,
                                   refine: bool = True):
        """Energy-mode search over the resident sketch (ascending |Δλ|, the
        cosine tie-break at sketch precision; λ exact), the carry scan;
        ``refine=True`` rescores the candidates exactly from disk."""
        if self.sub_centroids is None:
            raise ValueError("not an energy-mode index (no sub-centroid state)")
        if self._sketch is None:
            self.build_sketch()
        Q = self._queries(queries)
        q_lams = self._query_lambdas(Q)
        kk, C = self._candidate_width(k, candidates)
        mn, rng = float(self.min_lambdas), float(self.range_lambdas)
        X8s, mults, lams, valids = self._sketch
        best_s, best_i = _sketch_scan_topk(X8s, mults, lams, valids, Q, q_lams, 0.0, mn, rng,
                                           kk=C, energy=True)
        if not refine:
            return best_i[:, :kk].cpu().numpy().astype(np.int64), -best_s[:, :kk].cpu().numpy()
        return self.refine_energy_candidates(best_i.cpu().numpy(), Q, q_lams, mn, rng, kk)

    def refine_energy_candidates(self, ids, Q, q_lams, mn: float, rng: float, kk: int):
        """Energy-mode counterpart of :meth:`refine_candidates`."""
        return self._refine(ids, kk, lambda XU, lamU, u: _refine_energy_topk(
            XU, lamU, Q, q_lams, float(mn), float(rng), u, kk), np.inf)

    def search_energy_sketch(self, query, k: int, candidates: int | None = None,
                             refine: bool = True) -> list[tuple[int, float]]:
        ids, sc = self.search_energy_batch_sketch(np.asarray(query, np.float32)[None, :], k,
                                                  candidates=candidates, refine=refine)
        return [(int(i), float(s)) for i, s in zip(ids[0], sc[0]) if i >= 0]

    def search_energy_batch(self, queries, k: int):
        """Streamed energy search (λ distance ascending, the cosine
        tie-break); requires an energy-mode store."""
        if self.sub_centroids is None:
            raise ValueError("not an energy-mode index (no sub-centroid state)")
        Q = self._queries(queries)
        q_lams = self._query_lambdas(Q)
        kb = min(min(k, self.n_items), self.block_rows)
        mn, rng = float(self.min_lambdas), float(self.range_lambdas)

        def kernel(Xb, lamb, valid):
            return _energy_block_batch(Xb, lamb, Q, q_lams, mn, rng, valid, kb)

        return self._stream_topk(kernel, Q.shape[0], k, ascending=True)

    def search_energy(self, query, k: int):
        idx, sc = self.search_energy_batch(np.asarray(query, np.float32)[None, :], k)
        return [(int(i), float(s)) for i, s in zip(idx[0], sc[0]) if i >= 0]
