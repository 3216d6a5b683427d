"""Port vs reference: the HTTP serving layer (``serve.py``), on torch-CPU
and JAX-CPU over loopback sockets.

The reference's index is built once on JAX-CPU (the fixture of
``tests/test_serve.py``: ``make_gaussian_blob(100, 0.4)``, deterministic
clustering) and carried into the port with ``convert``, so both services
serve one index. Checks:

* the same requests give the same statuses, error texts and ``info()`` /
  ``metrics()`` keys;
* on the exact tier the same ids, scores within 1e-5;
* on every servable tier each package's service equals its own direct
  ``search_batch`` on the same batch (ids and scores equal).

Coalescing is asserted without thread timing: requests are placed in the
queue under the service's lock (:func:`_one_batch`), so the collector
cuts them together; a blocked dispatch and a wait on the queue's depth
(:func:`_block_dispatch`) stand in for load.
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from matternet_rs_tpu.builder import ArrowSpaceBuilder as JBuilder
from matternet_rs_tpu.serve import IndexService as JService
from matternet_rs_tpu.serve import serve as jserve
from matternet_rs_tpu.utils.fixtures import make_energy_test_dataset, make_gaussian_blob

from matternet_rs_tpu_torch import convert
from matternet_rs_tpu_torch import serve as tsv
from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder as TBuilder
from matternet_rs_tpu_torch.utils.parity import ENERGY_TIE_TOL, same_k_mismatches

CPU = "cpu"
TOL = 1e-5
TIMEOUT = 60
SERVE_TIERS = (False, True, "auto", "int8", "int8_rescored", "int8_auto", "bf16x3_rescored")


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, doc, raw=None):
    body = raw if raw is not None else json.dumps(doc).encode()
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _carry(ja, jg):
    """The reference's index as the port's (``convert`` leaves the
    cluster count, which ``info()`` reports, to the caller)."""
    ta, tg = convert.arrowspace_from_arrays(
        np.asarray(ja.data), np.asarray(ja.lambdas), np.asarray(jg.matrix),
        min_lambdas=ja.min_lambdas, max_lambdas=ja.max_lambdas, range_lambdas=ja.range_lambdas,
        graph_params=dataclasses.asdict(jg.graph_params),
        tau_mode=(ja.taumode.mode, ja.taumode.param), init_data=np.asarray(jg.init_data),
        nnodes=jg.nnodes, device=CPU)
    ta.n_clusters = ja.n_clusters
    return ta, tg


@pytest.fixture(scope="module")
def pair():
    """One index served by each package: ``{"ref": ..., "port": ...}`` of
    (base url, service, aspace, gl), and the rows."""
    data = make_gaussian_blob(100, 0.4).astype(np.float32)
    ja, jg = (JBuilder().with_lambda_graph(1.0, 6).with_sparsity_check(False)
              .with_cluster_params(max_clusters=10, radius=4.0)
              .with_deterministic_clustering(True).build(data))
    ta, tg = _carry(ja, jg)
    out, servers = {}, []
    for name, svc_cls, serve_fn, aspace, gl in (("ref", JService, jserve, ja, jg),
                                                 ("port", tsv.IndexService, tsv.serve, ta, tg)):
        svc = svc_cls(aspace, gl)
        srv = serve_fn(svc, port=0, block=False)
        servers.append((srv, svc))
        out[name] = (f"http://127.0.0.1:{srv.server_address[1]}", svc, aspace, gl)
    yield out, data
    for srv, svc in servers:
        srv.shutdown()
        svc.close()


def _pending(mod, svc, q, k=3, alpha=0.7, quantized=False, mode="blend", approx=False):
    return mod._Pending(svc._validate(q), k, alpha, approx, mode, quantized=quantized)


def _one_batch(svc, pendings):
    """Place ``pendings`` in the queue under the service's lock (the
    collector cuts them as one batch when their count reaches the backlog
    threshold or ``max_batch``) and wait for every answer."""
    with svc._cv:
        svc._queue.extend(pendings)
        svc.queue_depth_peak = max(svc.queue_depth_peak, len(svc._queue))
        svc._cv.notify_all()
    for p in pendings:
        assert p.done.wait(TIMEOUT), "a request was never answered"
    return pendings


def _block_dispatch(svc):
    """Make every dispatch wait for the returned event; ``entered`` counts
    the dispatches that reached the block."""
    release, entered = threading.Event(), []
    orig = svc._run_batch

    def blocking(*a, **kw):
        entered.append(1)
        assert release.wait(TIMEOUT)
        return orig(*a, **kw)

    svc._run_batch = blocking
    return release, entered


def _wait_until(cond, what):
    deadline = time.monotonic() + TIMEOUT
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def _client(svc, q, results, **kw):
    def run():
        try:
            results.append(("ok", svc.search(q, **kw)))
        except Exception as exc:  # noqa: BLE001 — the test reads it
            results.append(("err", exc))
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


# ------------------------------------------------ the same requests, both packages

BAD_REQUESTS = ("no query", "wrong dimension", "NaN", "bad JSON", "alpha null", "alpha list",
                "k text", "unknown tier", "low-recall tier", "zero query", "unknown path")


def _bad_requests(data):
    return {
        "no query": ("/search", {"k": 5}, None),
        "wrong dimension": ("/search", {"query": [1.0, 2.0]}, None),
        "NaN": ("/search", None, b'{"query": [NaN, 1, 1, 1, 1, 1, 1, 1, 1, 1]}'),
        "bad JSON": ("/search", None, b'{"query": [1.0,'),
        "alpha null": ("/search", {"query": data[0].tolist(), "k": 3, "alpha": None}, None),
        "alpha list": ("/search", {"query": data[0].tolist(), "k": 3, "alpha": [0.5]}, None),
        "k text": ("/search", {"query": data[0].tolist(), "k": "ten"}, None),
        "unknown tier": ("/search", {"query": data[3].tolist(), "quantized": "int9"}, None),
        "low-recall tier": ("/search", {"query": data[3].tolist(), "quantized": "bf16_rescored"},
                            None),
        "zero query": ("/search", {"query": [0.0] * 10}, None),
        "unknown path": ("/nope", {"query": [1.0] * 10}, None),
    }


EXPECTED_STATUS = {"zero query": 422, "unknown path": 404}


@pytest.mark.parametrize("case", BAD_REQUESTS)
def test_error_paths_give_the_reference_status_and_text(pair, case):
    services, data = pair
    path, doc, raw = _bad_requests(data)[case]
    got = {name: _post(base + path, doc, raw)[:2] for name, (base, *_rest) in services.items()}
    assert got["port"] == got["ref"]
    code, body = got["port"]
    assert code == EXPECTED_STATUS.get(case, 400) and body["error"]


def test_get_routes_and_their_keys(pair):
    services, data = pair
    for name, (base, svc, *_r) in services.items():
        _post(base + "/search", {"query": data[1].tolist(), "k": 3})
    docs = {name: {p: _get(base + p) for p in ("/health", "/info", "/metrics", "/nope")}
            for name, (base, *_r) in services.items()}
    for p in ("/health", "/info", "/metrics", "/nope"):
        assert docs["port"][p][0] == docs["ref"][p][0]
        assert set(docs["port"][p][1]) == set(docs["ref"][p][1]), p
    assert docs["port"]["/health"][1]["status"] == "ok"
    assert docs["port"]["/nope"] == docs["ref"]["/nope"]
    info = docs["port"]["/info"][1]
    assert info["n_items"] == 100 and not info["energy_mode"]
    for key in ("n_items", "n_features", "n_clusters", "energy_mode", "taumode"):
        assert info[key] == docs["ref"]["/info"][1][key], key


@pytest.mark.parametrize("alpha", [0.5, 0.7, 0.95])
def test_exact_tier_over_http_matches_the_reference(pair, alpha):
    services, data = pair
    for i in (0, 9, 42, 77):
        doc = {"query": data[i].tolist(), "k": 5, "alpha": alpha}
        (cr, ref, _), (cp, got, _) = (_post(services[n][0] + "/search", doc) for n in ("ref", "port"))
        assert cr == cp == 200
        assert [r["index"] for r in got["results"]] == [r["index"] for r in ref["results"]]
        np.testing.assert_allclose([r["score"] for r in got["results"]],
                                   [r["score"] for r in ref["results"]], atol=TOL, rtol=0)
        assert got["results"][0]["index"] == i


@pytest.mark.parametrize("tier", SERVE_TIERS, ids=str)
@pytest.mark.parametrize("package", ["ref", "port"])
def test_one_dispatch_of_mixed_alphas_equals_direct_search(pair, package, tier):
    """Eight requests with six alphas, placed in the queue together: one
    dispatch, each answer the direct ``search_batch`` of the same eight
    rows with the same alpha vector."""
    from matternet_rs_tpu import serve as jsv

    services, data = pair
    _base, svc, aspace, gl = services[package]
    mod = tsv if package == "port" else jsv
    rows = [3, 14, 27, 40, 58, 66, 81, 95]
    alphas = [0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.5, 0.6]
    b0 = svc.n_batches
    done = _one_batch(svc, [_pending(mod, svc, data[r], 5, a, tier) for r, a in zip(rows, alphas)])
    assert svc.n_batches - b0 == 1
    idx, sc = aspace.search_batch(data[rows], gl, 5, np.asarray(alphas, np.float32),
                                  quantized=tier)
    for p, ri, rs in zip(done, np.asarray(idx), np.asarray(sc)):
        assert p.error is None, p.error
        assert [r["index"] for r in p.result] == ri.tolist()
        assert [r["score"] for r in p.result] == [float(s) for s in rs]


def test_mixed_k_groups_per_k(pair):
    services, data = pair
    _base, svc, aspace, gl = services["port"]
    ks = [3, 5] * 4
    b0 = svc.n_batches
    done = _one_batch(svc, [_pending(tsv, svc, data[i], k, 0.5 + 0.05 * i) for i, k in enumerate(ks)])
    assert svc.n_batches - b0 == 2
    for i, (p, k) in enumerate(zip(done, ks)):
        assert len(p.result) == k and p.result[0]["index"] == i


def test_http_burst_answers_every_request(pair):
    """64 connections at once (the listen backlog is 256): every request
    answered 200 with its own row first, and each answer in the latency
    window once it has returned."""
    import concurrent.futures

    services, data = pair
    base, svc, *_r = services["port"]
    assert tsv._Server.request_queue_size == 256 and tsv._Server.daemon_threads
    n0 = svc.metrics()["latency_window"]

    def one(i):
        code, doc, _ = _post(base + "/search", {"query": data[i].tolist(), "k": 3,
                                                 "alpha": [0.5, 0.7, 0.9][i % 3]})
        return code, doc["results"][0]["index"]

    with concurrent.futures.ThreadPoolExecutor(max_workers=64) as ex:
        results = list(ex.map(one, range(64)))
    assert results == [(200, i) for i in range(64)]
    m = svc.metrics()
    assert m["latency_window"] >= n0 + 64
    assert m["batch_occupancy"] >= 1.0 and m["latency_p99_ms"] >= m["latency_p50_ms"] > 0
    for tag in ("queue_wait", "dispatch"):
        assert m[f"{tag}_p99_ms"] >= m[f"{tag}_p50_ms"] >= 0
        assert m[f"{tag}_p50_ms"] <= m["latency_p99_ms"]


# ------------------------------------------------ the service's own behaviour

@pytest.fixture(scope="module")
def small():
    """The reference's overload fixture (80 rows), built by the port."""
    data = make_gaussian_blob(80, 0.4).astype(np.float32)
    aspace, gl = (TBuilder(device=CPU).with_lambda_graph(1.0, 6).with_sparsity_check(False)
                  .with_cluster_params(max_clusters=8, radius=4.0)
                  .with_deterministic_clustering(True).build(data))
    return aspace, gl, data


def test_tier_names_reach_the_dispatch(small):
    aspace, gl, data = small
    svc = tsv.IndexService(aspace, gl)
    seen, orig = [], aspace.search_batch

    def recording(Q, gl_, k, alpha=0.7, **kw):
        seen.append(kw.get("quantized"))
        return orig(Q, gl_, k, alpha, **kw)

    aspace.search_batch = recording
    srv = tsv.serve(svc, port=0, block=False)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        for tier in SERVE_TIERS:
            code, _, _ = _post(base + "/search", {"query": data[3].tolist(), "k": 3, "quantized": tier})
            assert code == 200 and seen[-1] == tier
        for bad in ("bf16x3", "bf16_rescored"):
            with pytest.raises(ValueError, match="unknown or unserved"):
                svc.search(data[0], k=3, quantized=bad)
    finally:
        srv.shutdown()
        svc.close()
        del aspace.search_batch


def test_full_batch_dispatches_before_the_window(small):
    aspace, gl, data = small
    svc = tsv.IndexService(aspace, gl, batch_window_ms=5000.0, max_batch=4)
    try:
        pend = [_pending(tsv, svc, data[i]) for i in range(4)]
        with svc._cv:
            svc._queue.extend(pend)
            svc._cv.notify_all()
        # A cut at max_batch answers long before the 5 s window.
        assert all(p.done.wait(4.0) for p in pend)
        assert [p.result[0]["index"] for p in pend] == [0, 1, 2, 3]
        assert svc.n_batches == 1
    finally:
        svc.close()


def test_backpressure_coalesces_while_both_slots_are_busy(small):
    aspace, gl, data = small
    svc = tsv.IndexService(aspace, gl, batch_window_ms=1.0)
    release, entered = _block_dispatch(svc)
    results, threads = [], []
    try:
        for i in range(2):                         # one batch in each dispatch slot
            threads.append(_client(svc, data[i], results, k=3))
            _wait_until(lambda: len(entered) == i + 1, f"dispatch {i + 1}")
        for i in range(2, 26):                     # 24 arrivals while both are busy
            threads.append(_client(svc, data[i], results, k=3))
        _wait_until(lambda: len(svc._queue) == 24, "the backlog")
        release.set()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
        assert all(tag == "ok" for tag, _ in results) and len(results) == 26
        assert svc.n_batches == 3 and svc.metrics()["batch_occupancy"] == round(26 / 3, 2)
        assert svc.metrics()["queue_depth_peak"] == 24
    finally:
        release.set()
        svc.close()


def test_adaptive_window_skips_under_backlog(small):
    aspace, gl, data = small
    svc = tsv.IndexService(aspace, gl, batch_window_ms=5000.0)
    svc.adaptive_min_backlog = 1
    release, entered = _block_dispatch(svc)
    results, threads = [], []
    try:
        for i in range(2):
            threads.append(_client(svc, data[i], results, k=3))
            _wait_until(lambda: len(entered) == i + 1, f"dispatch {i + 1}")
        for i in range(2, 6):
            threads.append(_client(svc, data[i], results, k=3))
        _wait_until(lambda: len(svc._queue) == 4, "the backlog")
        t0 = time.monotonic()
        release.set()
        for t in threads:
            t.join(TIMEOUT)
        # Without the skip each cut would wait out the 5 s window.
        assert time.monotonic() - t0 < 3.0 and len(results) == 6
    finally:
        release.set()
        svc.close()


def test_admission_control_sheds_past_the_bound(small):
    aspace, gl, data = small
    svc = tsv.IndexService(aspace, gl, max_queue_depth=2, batch_window_ms=1.0)
    release, entered = _block_dispatch(svc)
    results, threads = [], []
    try:
        for i in range(2):
            threads.append(_client(svc, data[i], results, k=3))
            _wait_until(lambda: len(entered) == i + 1, f"dispatch {i + 1}")
        for i in range(2, 4):
            threads.append(_client(svc, data[i], results, k=3))
        _wait_until(lambda: len(svc._queue) == 2, "the backlog")
        with pytest.raises(tsv.ServiceOverloadedError, match="queue depth 2 at the admission bound"):
            svc.search(data[7], k=3)
        assert svc.metrics()["requests_shed"] == 1
        release.set()
        for t in threads:
            t.join(TIMEOUT)
        assert len(results) == 4 and all(tag == "ok" for tag, _ in results)
        assert svc.metrics()["queue_depth_peak"] == 2
    finally:
        release.set()
        svc.close()


@pytest.mark.parametrize("package", ["ref", "port"])
def test_http_429_on_a_full_queue(pair, package):
    """A ``max_queue_depth=1`` service with its queue filled under the
    lock: 429 with ``Retry-After: 1`` and the same text in both."""
    from matternet_rs_tpu import serve as jsv

    services, data = pair
    _b, _s, aspace, gl = services[package]
    mod = tsv if package == "port" else jsv
    svc = mod.IndexService(aspace, gl, max_queue_depth=1, batch_window_ms=1.0)
    release, entered = _block_dispatch(svc)
    srv = mod.serve(svc, port=0, block=False)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    results, threads = [], []
    try:
        for i in range(2):
            threads.append(_client(svc, data[i], results, k=3))
            _wait_until(lambda: len(entered) == i + 1, f"dispatch {i + 1}")
        threads.append(_client(svc, data[2], results, k=3))
        _wait_until(lambda: len(svc._queue) == 1, "the backlog")
        code, doc, headers = _post(base + "/search", {"query": data[0].tolist(), "k": 3})
        assert code == 429 and headers.get("Retry-After") == "1"
        assert doc["error"] == "queue depth 1 at the admission bound (1); retry with backoff"
        release.set()
        for t in threads:
            t.join(TIMEOUT)
        assert len(results) == 3 and all(tag == "ok" for tag, _ in results)
    finally:
        release.set()
        srv.shutdown()
        svc.close()


def test_metrics_reset_and_queue_depth(small):
    aspace, gl, data = small
    svc = tsv.IndexService(aspace, gl)
    try:
        svc.search(data[0], k=3)
        m = svc.metrics()
        assert m["latency_window"] == 1 and svc.n_queries == 1
        assert m["queue_depth"] == 0 and m["queue_depth_peak"] >= 1 and m["requests_shed"] == 0
        svc.reset_metrics()
        m = svc.metrics()
        assert m["latency_window"] == 0 and m["batch_occupancy"] is None
        assert "latency_p50_ms" not in m and m["queue_depth_peak"] == 0
        assert svc.n_queries == 0 and svc.n_batches == 0
        svc.search(data[1], k=3)
        assert svc.metrics()["latency_window"] == 1
    finally:
        svc.close()


def test_close_fails_queued_waiters_and_later_requests(small):
    aspace, gl, data = small
    svc = tsv.IndexService(aspace, gl, batch_window_ms=1.0)
    release, entered = _block_dispatch(svc)
    results, threads = [], []
    try:
        for i in range(2):
            threads.append(_client(svc, data[i], results, k=3))
            _wait_until(lambda: len(entered) == i + 1, f"dispatch {i + 1}")
        threads.append(_client(svc, data[2], results, k=3))
        _wait_until(lambda: len(svc._queue) == 1, "the backlog")
        svc.close()
        release.set()
        for t in threads:
            t.join(TIMEOUT)
        errors = [str(r) for tag, r in results if tag == "err"]
        assert errors == ["index service is closed"] and len(results) == 3
        with pytest.raises(RuntimeError, match="closed"):
            svc.search(data[0], k=3)
    finally:
        release.set()
        svc.close()


def test_a_failed_dispatch_reaches_every_request_of_its_batch(small):
    aspace, gl, data = small
    svc = tsv.IndexService(aspace, gl)

    def failing(*a, **kw):
        raise RuntimeError("device fault")

    svc._run_batch = failing
    try:
        done = _one_batch(svc, [_pending(tsv, svc, data[i]) for i in range(8)])
        assert all(str(p.error) == "device fault" and p.result is None for p in done)
        assert svc.n_batches == 0
    finally:
        svc.close()


def test_from_storage_loads_a_checkpoint(tmp_path, small):
    from matternet_rs_tpu_torch.storage import parquet as tpq

    aspace, gl, data = small
    b = TBuilder(device=CPU).with_lambda_graph(1.0, 6)
    tpq.save_checkpoint(aspace, gl, b, tmp_path, "ck")
    svc = tsv.IndexService.from_storage(tmp_path, "ck", device=CPU, max_batch=16)
    try:
        assert svc.max_batch == 16 and svc.aspace.device.type == "cpu"
        assert svc.search(data[5], k=3)[0]["index"] == 5
    finally:
        svc.close()


# ------------------------------------------------ energy mode

@pytest.fixture(scope="module")
def energy_pair():
    """The reference test's energy index (300 × 16, seed 9), built on
    JAX-CPU and carried into the port."""
    data = make_energy_test_dataset(300, 16, seed=9).astype(np.float32)
    ja, jg = (JBuilder().with_lambda_graph(1.0, 6).with_sparsity_check(False)
              .with_cluster_params(max_clusters=24, radius=25.0).with_dims_reduction(True)
              .with_expected_items(len(data)).build_energy(data))
    p = ja.projection
    ta, tg = convert.arrowspace_from_arrays(
        np.asarray(ja.data), np.asarray(ja.lambdas), np.asarray(jg.matrix),
        min_lambdas=ja.min_lambdas, max_lambdas=ja.max_lambdas, range_lambdas=ja.range_lambdas,
        graph_params=dataclasses.asdict(jg.graph_params),
        tau_mode=(ja.taumode.mode, ja.taumode.param), init_data=np.asarray(jg.init_data),
        nnodes=jg.nnodes, projection=None if p is None else (p.original_dim, p.reduced_dim, p.seed),
        sub_centroids=np.asarray(ja.sub_centroids),
        subcentroid_lambdas=np.asarray(ja.subcentroid_lambdas),
        centroid_map=np.asarray(ja.centroid_map), item_norms=np.asarray(ja.item_norms), device=CPU)
    return data, (ja, jg), (ta, tg)


@pytest.mark.parametrize("candidates", [None, "auto"])
def test_energy_endpoint_matches_the_reference(energy_pair, candidates):
    from matternet_rs_tpu_torch import energymaps as tem

    data, (ja, jg), (ta, tg) = energy_pair
    svcs = {"ref": JService(ja, jg, energy_candidates=candidates),
            "port": tsv.IndexService(ta, tg, energy_candidates=candidates)}
    srvs = {"ref": jserve(svcs["ref"], port=0, block=False),
            "port": tsv.serve(svcs["port"], port=0, block=False)}
    try:
        rows = [0, 8, 150, 299]
        got = {}
        for name, srv in srvs.items():
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            got[name] = [_post(base + "/search_energy", {"query": data[i].tolist(), "k": 5})
                         for i in rows]
        for (cr, ref, _), (cp, port, _), i in zip(got["ref"], got["port"], rows):
            assert cr == cp == 200
            assert any(r["index"] == i for r in port["results"])
            ids = [[[r["index"] for r in d["results"]]] for d in (ref, port)]
            dist = [[[r["distance"] for r in d["results"]]] for d in (ref, port)]
            assert not same_k_mismatches(ids[0], dist[0], ids[1], dist[1], ENERGY_TIE_TOL)
        # One dispatch of the four, equal to the direct batched search.
        done = _one_batch(svcs["port"], [_pending(tsv, svcs["port"], data[i], 5, mode="energy")
                                         for i in rows])
        idx, dd = tem.search_energy_batch(ta, data[rows], tg, 5, candidates=candidates)
        for p, ri, rd in zip(done, idx, dd):
            assert [r["index"] for r in p.result] == ri.tolist()
            assert [r["distance"] for r in p.result] == [float(d) for d in rd]
    finally:
        for name in srvs:
            srvs[name].shutdown()
            svcs[name].close()


def test_energy_approx_reaches_the_dispatch(energy_pair, monkeypatch):
    from matternet_rs_tpu_torch import energymaps as tem

    data, _, (ta, tg) = energy_pair
    seen, orig = [], tem.search_energy_batch

    def recording(aspace_, Q, gl_, k, **kw):
        seen.append(kw.get("approx"))
        return orig(aspace_, Q, gl_, k, **kw)

    monkeypatch.setattr(tem, "search_energy_batch", recording)
    svc = tsv.IndexService(ta, tg)
    try:
        svc.search_energy(data[2], k=3, approx=True)
        assert seen[-1] is True
        svc.search_energy(data[2], k=3)
        assert seen[-1] is False
    finally:
        svc.close()


def test_blend_search_on_an_energy_index_is_not_undecidable():
    """On an energy index the query nearest the minimum-λ sub-centroid has
    normalised λ exactly 0: ``/search`` answers it (no 422)."""
    data = make_energy_test_dataset(150, 24, seed=17).astype(np.float32)
    aspace, gl = (TBuilder(device=CPU).with_lambda_graph(1.0, 5).with_sparsity_check(False)
                  .with_cluster_params(max_clusters=16, radius=18.0)
                  .with_dims_reduction(True).with_seed(3).build_energy(data))
    svc = tsv.IndexService(aspace, gl)
    try:
        qi = int(np.argmin(aspace.lambdas.numpy()))
        assert svc.search(data[qi], k=3)[0]["index"] == qi
    finally:
        svc.close()


# ------------------------------------------------ streaming

@pytest.fixture(scope="module")
def streaming_pair(tmp_path_factory):
    """The reference test's store (2,000 × 24, seed 5), built by the
    reference and served by both packages through the resident sketch."""
    from matternet_rs_tpu.graph import GraphParams as JGraphParams
    from matternet_rs_tpu.index.streaming import StreamingIndex as JStreaming
    from matternet_rs_tpu.serve import StreamingIndexService as JStreamingService
    from matternet_rs_tpu.storage import shards as jshards

    d = tmp_path_factory.mktemp("serve_store")
    data = make_energy_test_dataset(2000, 24, seed=5).astype(np.float32)
    jshards.write_shards(data, d, rows_per_shard=700)
    ji = JStreaming.build_from_store(d, JGraphParams(eps=1.0, k=6, topk=6, sparsity_check=False),
                                     max_clusters=16, radius=20.0, block_rows=512,
                                     sample_rows=2000)
    svcs = {"ref": JStreamingService(ji, sketch=True),
            "port": tsv.StreamingIndexService.from_store(d, device=CPU, sketch=True)}
    srvs = {"ref": jserve(svcs["ref"], port=0, block=False),
            "port": tsv.serve(svcs["port"], port=0, block=False)}
    bases = {n: f"http://127.0.0.1:{s.server_address[1]}" for n, s in srvs.items()}
    yield bases, svcs, data, d
    for n in srvs:
        srvs[n].shutdown()
        svcs[n].close()


def test_streaming_info_keys_match(streaming_pair):
    bases, _, _, _ = streaming_pair
    ref, port = _get(bases["ref"] + "/info"), _get(bases["port"] + "/info")
    assert ref[0] == port[0] == 200 and set(ref[1]) == set(port[1])
    doc = port[1]
    assert doc["streaming"] is True and doc["sketch"] is True
    assert doc["n_items"] == 2000 and doc["mesh_devices"] == 0


@pytest.mark.parametrize("approx", [False, True], ids=["refined", "sketch-only"])
def test_streaming_search_matches_the_reference_and_the_direct_call(streaming_pair, approx):
    bases, svcs, data, _ = streaming_pair
    for qi in (3, 42, 777):
        doc = {"query": data[qi].tolist(), "k": 5, "approx": approx}
        (cr, ref, _), (cp, got, _) = (_post(bases[n] + "/search", doc) for n in ("ref", "port"))
        assert cr == cp == 200 and got["results"][0]["index"] == qi
        assert [r["index"] for r in got["results"]] == [r["index"] for r in ref["results"]]
    rows = list(range(100, 108))
    alphas = [0.5 + 0.05 * i for i in range(8)]
    svc = svcs["port"]
    b0 = svc.n_batches
    done = _one_batch(svc, [_pending(tsv, svc, data[r], 5, a, approx=approx)
                            for r, a in zip(rows, alphas)])
    assert svc.n_batches - b0 == 1
    idx, sc = svc.index.search_batch_sketch(data[rows], 5, np.asarray(alphas, np.float32),
                                            refine=not approx)
    for p, ri, rs in zip(done, idx, sc):
        assert [r["index"] for r in p.result] == ri.tolist()
        assert [r["score"] for r in p.result] == [float(s) for s in rs]


@pytest.mark.parametrize("case", ["energy on an eigen store", "wrong dimension"])
def test_streaming_errors_match_the_reference(streaming_pair, case):
    bases, _, data, _ = streaming_pair
    path, doc = {"energy on an eigen store": ("/search_energy", {"query": data[7].tolist(), "k": 3}),
                 "wrong dimension": ("/search", {"query": [1.0, 2.0], "k": 3})}[case]
    ref, port = (_post(bases[n] + path, doc)[:2] for n in ("ref", "port"))
    assert port[0] == ref[0] == 400
    assert ("energy-mode" if "energy" in case else "dimension") in port[1]["error"]


def test_streaming_without_sketch_and_with_a_mesh(streaming_pair):
    _, _, data, d = streaming_pair
    svc = tsv.StreamingIndexService.from_store(d, device=CPU, sketch=False)
    try:
        for qz in (False, True):
            res = svc.search(data[42], k=5, quantized=qz)
            ref = svc.index.search_batch(data[42][None], 5, 0.7, quantized=qz)
            assert [r["index"] for r in res] == ref[0][0].tolist() and res[0]["index"] == 42
    finally:
        svc.close()
    # With a mesh the sketch is sharded (4 CPU slots here; it waited for
    # the port of parallel/ before): info names the slots, and the
    # answers equal the reference's service over its 4-device mesh and the
    # single-card sketch search (the carry scan is exact at sketch
    # precision, so the sharded scan keeps the same candidates).
    from matternet_rs_tpu.parallel import make_mesh as jmake_mesh
    from matternet_rs_tpu.serve import StreamingIndexService as JStreamingService
    from matternet_rs_tpu_torch.parallel import make_mesh

    svc = tsv.StreamingIndexService.from_store(d, device=CPU,
                                               mesh=make_mesh(4, devices=[CPU] * 4))
    ref_svc = JStreamingService.from_store(d, mesh=jmake_mesh(4))
    try:
        assert svc.info()["mesh_devices"] == ref_svc.info()["mesh_devices"] == 4
        for approx in (False, True):
            for qi in (3, 42):
                res = svc.search(data[qi], k=5, approx=approx)
                ref = ref_svc.search(data[qi], k=5, approx=approx)
                one = svc.index.search_batch_sketch(data[qi][None], 5, refine=not approx)
                assert [r["index"] for r in res] == [r["index"] for r in ref] == one[0][0].tolist()
                np.testing.assert_allclose([r["score"] for r in res], one[1][0], rtol=0, atol=0)
        e = svc.search_energy(data[3], k=3) if svc.index.sub_centroids is not None else None
        assert e is None
    finally:
        svc.close()
        ref_svc.close()


def test_module_names_follow_the_reference():
    import inspect

    from matternet_rs_tpu import serve as jsv

    def public(mod):
        return {n for n, v in vars(mod).items() if (inspect.isfunction(v) or inspect.isclass(v))
                and v.__module__ == mod.__name__}

    assert public(jsv) == public(tsv)
    assert tsv._SERVE_TIERS == jsv._SERVE_TIERS
    for cls in ("IndexService", "StreamingIndexService"):
        for meth in ("search", "search_energy", "info", "metrics", "reset_metrics", "close"):
            assert (list(inspect.signature(getattr(getattr(tsv, cls), meth)).parameters)
                    == list(inspect.signature(getattr(getattr(jsv, cls), meth)).parameters))
    for cls in ("IndexService", "StreamingIndexService"):
        assert (list(inspect.signature(getattr(tsv, cls).__init__).parameters)
                == list(inspect.signature(getattr(jsv, cls).__init__).parameters))
    assert list(inspect.signature(tsv.serve).parameters) == list(inspect.signature(jsv.serve).parameters)
