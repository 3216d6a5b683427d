"""Minimal HTTP serving layer for a built index (twin of the reference's
``serve.py``).

Stdlib-only HTTP server exposing:

* ``GET  /health``         → {"status": "ok", ...}
* ``GET  /info``           → index metadata
* ``POST /search``         → {"query": [floats], "k": 10, "alpha": 0.7,
                              "approx": false, "quantized": false}
                              → ranked results (``quantized`` names a scan
                              tier of ``ArrowSpace.search_batch``)
* ``POST /search_energy``  → energy-mode search (if the index was built
                              with the energy pipeline)
* ``GET  /metrics``        → batch occupancy + request latency p50/p99
                              over the recent window

Queries are validated and errors return structured JSON (400 for bad
requests, 422 for undecidable queries, 429 when the queue is at its
admission bound) instead of taking the server down. The index lives on the
CUDA card unless it was loaded with ``device="cpu"``; a failed dispatch is
handed to every request of its batch, never answered with a 200.

Two dispatch threads may launch kernels at once. They share the card's
current stream, so the card runs their batches one after the other while
the host-side preparation of one overlaps the other's device work.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from matternet_rs_tpu_torch.core import (
    LOW_RECALL_TIERS as _LOW_RECALL_TIERS,
    QUANT_TIERS as _QUANT_TIERS,
    ArrowSpace,
    UndecidableQueryError,
)
from matternet_rs_tpu_torch.graph import GraphLaplacian

log = logging.getLogger(__name__)

# The named scan tiers the service accepts for ``quantized`` beyond the
# bf16-copy bool: the search's tiers minus the gated low-recall ones
# (serving has no allow_low_recall override). Unknown strings are rejected
# at the HTTP edge (400) and by IndexService.search (ValueError) rather
# than coerced to the bf16 scan.
_SERVE_TIERS = frozenset(_QUANT_TIERS - _LOW_RECALL_TIERS)


class ServiceOverloadedError(RuntimeError):
    """Admission control: raised by ``_submit`` when the request queue is
    at ``max_queue_depth`` — mapped to HTTP 429 at the edge. Shedding at
    admission keeps the queue-wait tail bounded instead of letting every
    accepted request pay the full backlog."""


@dataclasses.dataclass
class _Pending:
    """One enqueued request waiting for a batch dispatch."""

    query: np.ndarray
    k: int
    alpha: float
    approx: bool
    mode: str                      # "blend" | "energy"
    # False = exact f32; True = bf16 corpus scan; a tier name otherwise
    # (blend mode only)
    quantized: bool | str = False
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Optional[list] = None
    error: Optional[Exception] = None
    t_submit: float = dataclasses.field(default_factory=time.monotonic)


class IndexService:
    """Thread-safe query service over a loaded index.

    Concurrent requests are micro-batched: a collector thread drains the
    queue every ``batch_window_ms`` (or at ``max_batch``), groups requests
    by (mode, k, approx, quantized, query width) — alpha rides along as a
    per-query vector — and dispatches ONE ``search_batch`` /
    ``search_energy_batch`` per group, so one ``[B, F]×[F, N]`` scan
    amortises the corpus read across the batch.

    Sparse traffic dispatches after ``batch_window_ms``; a full
    ``max_batch`` dispatches at once.
    """

    def __init__(self, aspace: ArrowSpace, gl: GraphLaplacian,
                 batch_window_ms: float = 2.0, max_batch: int = 256,
                 energy_candidates=None,
                 max_queue_depth: Optional[int] = None):
        self.aspace = aspace
        self.gl = gl
        self._nfeatures = aspace.nfeatures
        # Banded two-stage energy dispatch: int window, "auto", or None for
        # the single-pass full scan (energymaps.search_energy_batch).
        self.energy_candidates = energy_candidates
        self._init_batching(batch_window_ms, max_batch, max_queue_depth)

    def _init_batching(self, batch_window_ms: float, max_batch: int,
                       max_queue_depth: Optional[int] = None) -> None:
        self.batch_window_s = batch_window_ms / 1000.0
        self.max_batch = max_batch
        # Admission bound: None accepts everything; an int sheds with
        # ServiceOverloadedError (HTTP 429) once the undispatched queue
        # reaches this depth.
        self.max_queue_depth = max_queue_depth
        # Backlog at slot acquisition above which the collector skips its
        # window: arrivals already coalesced during the last dispatch.
        self.adaptive_min_backlog = 8
        self.queue_depth_peak = 0
        self.n_shed = 0
        self._queue: list[_Pending] = []
        self._cv = threading.Condition()
        self._closed = False
        self.n_queries = 0
        self.n_batches = 0
        # Per-request latency samples, newest-wins ring: (total, queue
        # wait, dispatch) seconds — the split separates batcher time from
        # device + fetch time.
        self._lat_ring = np.zeros((4096, 3), np.float64)
        self._lat_n = 0
        # Double-buffered dispatch: the collector hands each group to this
        # 2-worker pool and resumes collecting. In-flight dispatches are
        # bounded by the semaphore (one permit per worker): while both
        # workers are busy the collector blocks and arrivals coalesce into
        # the next batch, which is cut when a slot frees.
        self._inflight = threading.BoundedSemaphore(2)
        self._dispatch_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="index-dispatch"
        )
        self._worker = threading.Thread(target=self._batch_loop, daemon=True)
        self._worker.start()

    @classmethod
    def from_storage(cls, path, name: str = "index", device=None,
                     **kwargs) -> "IndexService":
        """Serve a checkpoint, loaded on ``device`` (None: the CUDA card)."""
        from matternet_rs_tpu_torch.storage import parquet as pq

        return cls(*pq.load_arrowspace(path, name, device=device), **kwargs)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            drained, self._queue = self._queue, []
            self._cv.notify_all()
        # Fail queued waiters instead of leaving them blocked forever.
        for p in drained:
            if not p.done.is_set():
                p.error = RuntimeError("index service is closed")
                p.done.set()
        # In-flight dispatches finish (their waiters get results); no new
        # submissions are accepted — a racing collector runs inline.
        self._dispatch_pool.shutdown(wait=False)

    def info(self) -> dict:
        return {
            "n_items": self.aspace.nitems,
            "n_features": self.aspace.nfeatures,
            "n_clusters": self.aspace.n_clusters,
            "energy_mode": self.aspace.sub_centroids is not None,
            "taumode": self.aspace.taumode.name,
            "queries_served": self.n_queries,
            "batches_dispatched": self.n_batches,
            **self.metrics(),
        }

    def metrics(self) -> dict:
        """Batch occupancy and request latency percentiles over the recent
        window, split into queue wait (submit → dispatch start: window and
        backpressure) and dispatch (device work and the result's fetch)."""
        with self._cv:
            n_q, n_b = self.n_queries, self.n_batches
            n = min(self._lat_n, len(self._lat_ring))
            lat = np.sort(self._lat_ring[:n], axis=0) if n else None
            depth, peak, shed = (
                len(self._queue), self.queue_depth_peak, self.n_shed,
            )
        out = {
            "batch_occupancy": round(n_q / n_b, 2) if n_b else None,
            "latency_window": n,
            "queue_depth": depth,
            "queue_depth_peak": peak,
            "requests_shed": shed,
        }
        if lat is not None:
            for col, tag in ((0, "latency"), (1, "queue_wait"), (2, "dispatch")):
                out[f"{tag}_p50_ms"] = round(
                    float(lat[int(0.50 * (n - 1)), col]) * 1e3, 2
                )
                out[f"{tag}_p99_ms"] = round(
                    float(lat[int(0.99 * (n - 1)), col]) * 1e3, 2
                )
        return out

    def reset_metrics(self) -> None:
        """Zero the telemetry window (counters and latency ring), so a
        measured window can leave out warm-up batches."""
        with self._cv:
            self.n_queries = 0
            self.n_batches = 0
            self._lat_n = 0
            self.queue_depth_peak = 0
            self.n_shed = 0

    # ------------------------------------------------------------------
    # micro-batching
    # ------------------------------------------------------------------
    def _submit(self, pending: _Pending) -> list[dict]:
        with self._cv:
            if self._closed:
                raise RuntimeError("index service is closed")
            depth = len(self._queue)
            if (self.max_queue_depth is not None
                    and depth >= self.max_queue_depth):
                self.n_shed += 1
                raise ServiceOverloadedError(
                    f"queue depth {depth} at the admission bound "
                    f"({self.max_queue_depth}); retry with backoff"
                )
            self._queue.append(pending)
            if depth + 1 > self.queue_depth_peak:
                self.queue_depth_peak = depth + 1
            self._cv.notify()
        pending.done.wait()
        if pending.error is not None:
            raise pending.error
        return pending.result

    def _batch_loop(self) -> None:
        while True:
            # Backpressure first: hold a dispatch slot before cutting a
            # batch, so while both workers are busy the queue coalesces.
            self._inflight.acquire()
            held = True
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    self._inflight.release()
                    return
                # Collect until the window elapses or a full batch is
                # ready; with a backlog of adaptive_min_backlog or more at
                # slot acquisition, cut at once.
                if len(self._queue) < self.adaptive_min_backlog:
                    deadline = time.monotonic() + self.batch_window_s
                    while len(self._queue) < self.max_batch and not self._closed:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(timeout=remaining)
                batch, self._queue = self._queue[: self.max_batch * 4], \
                    self._queue[self.max_batch * 4:]
            # Group without alpha: the search takes a per-query alpha
            # vector, so mixed blend weights share one dispatch.
            groups: dict[tuple, list[_Pending]] = {}
            for p in batch:
                groups.setdefault(
                    (p.mode, p.k, p.approx, p.quantized, p.query.shape[0]),
                    [],
                ).append(p)
            for (mode, k, approx, quantized, _dim), members in groups.items():
                for start in range(0, len(members), self.max_batch):
                    chunk = members[start : start + self.max_batch]
                    if not held:
                        # One permit per submitted chunk; _dispatch
                        # releases it in its finally block.
                        self._inflight.acquire()
                    held = False
                    try:
                        self._dispatch_pool.submit(
                            self._dispatch, mode, k, approx, quantized, chunk
                        )
                    except RuntimeError:
                        # Pool already shut down (close() raced the drain):
                        # run inline so no waiter is left hanging.
                        self._dispatch(mode, k, approx, quantized, chunk)
            if held:
                self._inflight.release()     # collected but produced no chunk

    def _record_latency(self, members: list[_Pending], t_dispatch: float) -> None:
        now = time.monotonic()
        for p in members:
            self._lat_ring[self._lat_n % len(self._lat_ring)] = (
                now - p.t_submit,           # total
                t_dispatch - p.t_submit,    # queue wait (window + backlog)
                now - t_dispatch,           # device dispatch + fetch
            )
            self._lat_n += 1

    def _dispatch(self, mode: str, k: int, approx: bool,
                  quantized: bool, members: list[_Pending]) -> None:
        """Run the batch, record telemetry, then release the waiters:
        ``p.done`` is set after the batch's telemetry lands, so a
        ``metrics()`` read taken once every request has returned counts
        every batch. Any failure goes to every member."""
        t_dispatch = time.monotonic()
        try:
            self._run_batch(mode, k, approx, quantized, members)
            with self._cv:
                self.n_queries += len(members)
                self.n_batches += 1
                self._record_latency(members, t_dispatch)
        except Exception as exc:  # noqa: BLE001 — deliver to every waiter
            log.debug("dispatch failed", exc_info=True)
            for p in members:
                if p.error is None and p.result is None:
                    p.error = exc
        finally:
            for p in members:
                p.done.set()
            # Free the dispatch slot last: the collector may cut the next
            # batch the moment this returns.
            try:
                self._inflight.release()
            except ValueError:
                pass                       # close() raced an inline call

    def _run_batch(self, mode: str, k: int, approx: bool,
                   quantized: bool, members: list[_Pending]) -> None:
        Q = np.stack([p.query for p in members])
        if mode == "energy":
            from matternet_rs_tpu_torch import energymaps

            idx, dist = energymaps.search_energy_batch(
                self.aspace, Q, self.gl, k, approx=approx,
                candidates=self.energy_candidates,
            )
            for p, row_i, row_d in zip(members, idx, dist):
                p.result = [
                    {"index": int(i), "distance": float(d)}
                    for i, d in zip(row_i, row_d)
                ]
        else:
            alphas = np.asarray([p.alpha for p in members], np.float32)
            idx, sc, raw = self.aspace.search_batch(
                Q, self.gl, k, alphas, approx=approx, return_raw=True,
                quantized=quantized,
            )
            # The undecidable check applies to eigen-mode raw λ only: in
            # energy mode ``raw`` is the nearest sub-centroid's normalised
            # λ, where exactly 0.0 is a legitimate value.
            energy_index = self.aspace.sub_centroids is not None
            for p, row_i, row_s, r in zip(members, idx, sc, raw):
                if not energy_index and abs(float(r)) <= 1e-12:
                    p.error = UndecidableQueryError(
                        "query raw λ is 0.0 (out of context for the "
                        "dataset — check the builder's eps)"
                    )
                else:
                    p.result = [
                        {"index": int(i), "score": float(s)}
                        for i, s in zip(row_i, row_s)
                    ]

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def _validate(self, query) -> np.ndarray:
        q = np.asarray(query, np.float32)
        if q.ndim != 1:
            raise ValueError("query must be a flat vector")
        # The batched scorers dot the query against the original-width
        # corpus, so only nfeatures-wide queries are servable.
        if q.shape[0] != self._nfeatures:
            raise ValueError(
                f"Query dimension {q.shape[0]} doesn't match index "
                f"dimension {self._nfeatures}"
            )
        if not np.all(np.isfinite(q)):
            raise ValueError("query item has non-finite values")
        return q

    def search(self, query, k: int = 10, alpha: float = 0.7,
               approx: bool = False, quantized: bool | str = False
               ) -> list[dict]:
        q = self._validate(query)
        # quantized is False / True / a named tier; an unknown string
        # raises here, matching the HTTP edge's 400.
        if isinstance(quantized, str) and quantized not in _SERVE_TIERS:
            raise ValueError(
                f"unknown or unserved quantized tier {quantized!r}: "
                f"expected a bool or one of {sorted(_SERVE_TIERS)} "
                "(gated low-recall tiers are not servable)"
            )
        qz = quantized if quantized in _SERVE_TIERS else bool(quantized)
        return self._submit(
            _Pending(q, int(k), float(alpha), bool(approx), "blend",
                     quantized=qz)
        )

    def search_energy(self, query, k: int = 10,
                      approx: bool = False) -> list[dict]:
        """``approx`` maps to the dispatch's energy approx path
        (IndexService: the search's ``approx``, which selects exactly;
        StreamingIndexService: sketch-only, no disk rescore)."""
        q = self._validate(query)
        return self._submit(_Pending(q, int(k), 0.0, bool(approx), "energy"))


class StreamingIndexService(IndexService):
    """Micro-batched service over an out-of-core :class:`StreamingIndex`.

    Same HTTP surface and collector as :class:`IndexService`, but the
    corpus lives on disk and (by default) the resident int8 sketch on the
    card serves every query with an exact disk rescore. On ``POST
    /search``, ``approx=True`` selects the sketch-only mode
    (``refine=False``), and ``quantized`` selects bf16 blocks on the
    streamed exact path without the sketch. With ``mesh`` the sketch is
    sharded over a device mesh (:class:`..parallel.sketch.ShardedSketch`:
    sketches larger than one card) behind the same search contract, so
    the dispatch is shared.
    """

    def __init__(self, index, batch_window_ms: float = 2.0,
                 max_batch: int = 256, sketch: bool = True,
                 candidates: Optional[int] = None, mesh=None,
                 max_queue_depth: Optional[int] = None):
        self.index = index
        self.use_sketch = sketch
        self.candidates = candidates
        self._nfeatures = index.n_features
        self.mesh_devices = 0
        if sketch and mesh is not None:
            from matternet_rs_tpu_torch.parallel.sketch import ShardedSketch

            sk = ShardedSketch(index, mesh)
            self._sketch_search = sk.search_batch
            self._energy_search = sk.search_energy_batch
            self.mesh_devices = mesh.size
        elif sketch:
            index.build_sketch()     # pay the one-time upload up front
            self._sketch_search = index.search_batch_sketch
            self._energy_search = index.search_energy_batch_sketch
        self._init_batching(batch_window_ms, max_batch, max_queue_depth)

    @classmethod
    def from_store(cls, directory, device=None, **kwargs) -> "StreamingIndexService":
        """Serve a store, its graph and sketch on ``device`` (None: the
        CUDA card)."""
        from matternet_rs_tpu_torch.index.streaming import StreamingIndex

        return cls(StreamingIndex.load(directory, device=device), **kwargs)

    def info(self) -> dict:
        return {
            "n_items": self.index.n_items,
            "n_features": self.index.n_features,
            "streaming": True,
            "sketch": self.use_sketch,
            "mesh_devices": self.mesh_devices,
            "energy_mode": self.index.sub_centroids is not None,
            "queries_served": self.n_queries,
            "batches_dispatched": self.n_batches,
            **self.metrics(),
        }

    def _run_batch(self, mode: str, k: int, approx: bool,
                   quantized: bool, members: list[_Pending]) -> None:
        Q = np.stack([p.query for p in members])
        if mode == "energy":
            if self.use_sketch:
                # The resident sketch's energy scan; approx=True skips the
                # disk rescore.
                idx, dist = self._energy_search(
                    Q, k, candidates=self.candidates,
                    refine=not approx,
                )
            else:
                idx, dist = self.index.search_energy_batch(Q, k)
            for p, row_i, row_d in zip(members, idx, dist):
                p.result = [
                    {"index": int(i), "distance": float(d)}
                    for i, d in zip(row_i, row_d) if i >= 0
                ]
        else:
            alphas = np.asarray([p.alpha for p in members], np.float32)
            if self.use_sketch:
                idx, sc = self._sketch_search(
                    Q, k, alphas, candidates=self.candidates,
                    refine=not approx,
                )
            else:
                idx, sc = self.index.search_batch(
                    Q, k, alphas, quantized=quantized
                )
            for p, row_i, row_s in zip(members, idx, sc):
                p.result = [
                    {"index": int(i), "score": float(s)}
                    for i, s in zip(row_i, row_s) if i >= 0
                ]


def make_handler(service: IndexService):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict,
                   headers: dict | None = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for name, val in (headers or {}).items():
                self.send_header(name, val)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):   # route to logging, not stderr
            log.debug("http: " + fmt, *args)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, {"status": "ok", **service.info()})
            elif self.path == "/info":
                self._reply(200, service.info())
            elif self.path == "/metrics":
                self._reply(200, service.metrics())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError) as exc:
                return self._reply(400, {"error": f"bad JSON body: {exc}"})

            query = doc.get("query")
            if not isinstance(query, list) or not query:
                return self._reply(400, {"error": "'query' must be a non-empty list"})
            try:
                k = int(doc.get("k", 10))
            except (TypeError, ValueError):
                return self._reply(400, {"error": "'k' must be an integer"})
            try:
                alpha = float(doc.get("alpha", 0.7))
            except (TypeError, ValueError):
                return self._reply(400, {"error": "'alpha' must be a number"})
            qz = doc.get("quantized", False)
            if isinstance(qz, str) and qz not in _SERVE_TIERS:
                return self._reply(400, {
                    "error": f"unknown or unserved quantized tier {qz!r}; "
                             f"one of {sorted(_SERVE_TIERS)} or a bool"
                })
            if qz not in _SERVE_TIERS:   # False / True / named tier
                qz = bool(qz)

            try:
                if self.path == "/search":
                    results = service.search(
                        query, k, alpha,
                        bool(doc.get("approx", False)),
                        qz,
                    )
                elif self.path == "/search_energy":
                    results = service.search_energy(
                        query, k, approx=bool(doc.get("approx", False))
                    )
                else:
                    return self._reply(404, {"error": f"unknown path {self.path}"})
            except UndecidableQueryError as exc:
                return self._reply(422, {"error": str(exc)})
            except ServiceOverloadedError as exc:
                # Admission control: the client backs off and retries.
                return self._reply(
                    429, {"error": str(exc)},
                    headers={"Retry-After": "1"},
                )
            except ValueError as exc:
                return self._reply(400, {"error": str(exc)})
            self._reply(200, {"results": results})

    return Handler


class _Server(ThreadingHTTPServer):
    # TCPServer's default accept backlog is 5: a burst of concurrent
    # clients beyond that is reset before a handler runs. Deep backlog,
    # and no per-thread join on shutdown.
    request_queue_size = 256
    daemon_threads = True


def serve(service: IndexService, host: str = "127.0.0.1", port: int = 8757,
          block: bool = True) -> ThreadingHTTPServer:
    server = _Server((host, port), make_handler(service))
    log.info("serving index on http://%s:%d", host, port)
    if block:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.shutdown()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
