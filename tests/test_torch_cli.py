"""Port vs reference: the command-line interface (``__main__.py``), run
in-process on torch-CPU (``--device cpu``) beside the reference's on
JAX-CPU, and ``serve`` as a subprocess.

Checks: the two CLIs build the same ``.npy`` into checkpoints that each
package's ``search`` reads, with the same ids (scores within 1e-5, the
CLI rounds to 6 digits); ``info`` prints the metadata; the streaming
subcommands run on a small store; the mesh subcommands run on CPU slots;
the ``serve`` subprocess answers as the in-process search of its
checkpoint."""

import json
import os
import pathlib
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from matternet_rs_tpu.__main__ import main as jmain
from matternet_rs_tpu.utils.fixtures import make_gaussian_blob

from matternet_rs_tpu_torch.__main__ import main as tmain

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
TOL = 1e-5


def _run(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture()
def data_file(tmp_path):
    data = make_gaussian_blob(120, 0.4).astype(np.float32)
    path = tmp_path / "data.npy"
    np.save(path, data)
    qpath = tmp_path / "q.npy"
    np.save(qpath, data[[7, 30, 77, 101]])
    return path, qpath, data


def test_each_cli_searches_the_others_checkpoint(data_file, tmp_path, capsys):
    data_path, q_path, _ = data_file
    build = [str(data_path), "--name", "t", "--max-clusters", "10", "--radius", "4.0"]
    built = {"ref": _run(jmain, ["build", *build, "--out", str(tmp_path / "ref")], capsys),
             "port": _run(tmain, ["build", *build, "--out", str(tmp_path / "port"), *CPU], capsys)}
    assert built["port"]["status"] == "built" and built["port"]["n_items"] == 120
    assert {k: v for k, v in built["port"].items() if k != "out"} == \
        {k: v for k, v in built["ref"].items() if k != "out"}
    for ckpt in ("ref", "port"):
        search = ["search", str(tmp_path / ckpt), "--name", "t", "--query", str(q_path), "--k", "5"]
        ref = _run(jmain, search, capsys)["results"]
        got = _run(tmain, search + CPU, capsys)["results"]
        assert [[r["index"] for r in row] for row in got] == [[r["index"] for r in row] for row in ref]
        assert [row[0]["index"] for row in got] == [7, 30, 77, 101]
        np.testing.assert_allclose([[r["score"] for r in row] for row in got],
                                   [[r["score"] for r in row] for row in ref], atol=TOL, rtol=0)
    tmain(["info", str(tmp_path / "port"), "--name", "t"])
    meta = json.loads(capsys.readouterr().out)
    assert meta["arrowspace"]["nitems"] == 120


def test_energy_build_and_search(data_file, tmp_path, capsys):
    data_path, q_path, _ = data_file
    out = tmp_path / "e"
    built = _run(tmain, ["build", str(data_path), "--out", str(out), "--pipeline", "energy",
                         "--max-clusters", "10", "--radius", "4.0", "--dims-reduction", *CPU],
                 capsys)
    assert built["pipeline"] == "energy"
    res = _run(tmain, ["search", str(out), "--query", str(q_path), "--k", "5", *CPU], capsys)
    for row, want in zip(res["results"], [7, 30, 77, 101]):
        assert "distance" in row[0] and want in [r["index"] for r in row]


def test_cli_rejects_unknown_format(tmp_path):
    with pytest.raises(SystemExit):
        tmain(["build", "data.csv", "--out", str(tmp_path), *CPU])


def test_streaming_subcommands(data_file, tmp_path, capsys):
    """shard-write → build-streaming (with --emit-sketch, then --resume) →
    search-streaming, streamed and on the sketch; the same ids as the
    reference's search of the same store."""
    data_path, q_path, _ = data_file
    store = tmp_path / "store"
    sharded = _run(tmain, ["shard-write", str(data_path), "--out", str(store),
                           "--rows-per-shard", "50"], capsys)
    assert sharded["n_rows"] == 120 and len(sharded["shards"]) == 3
    build = ["build-streaming", str(store), "--max-clusters", "10", "--radius", "4.0",
             "--block-rows", "64", "--sample-rows", "120"]
    built = _run(tmain, build + ["--emit-sketch", *CPU], capsys)
    assert built["status"] == "built" and built["n_items"] == 120
    assert (store / "sketch.bin").exists() and (store / "sketch_meta.npz").exists()
    assert _run(tmain, build + ["--resume", *CPU], capsys)["status"] == "built"
    for extra in ([], ["--sketch"]):
        search = ["search-streaming", str(store), "--query", str(q_path), "--k", "5", *extra]
        got = _run(tmain, search + CPU, capsys)["results"]
        ref = _run(jmain, search, capsys)["results"]
        assert [row[0]["index"] for row in got] == [7, 30, 77, 101]
        assert [[r["index"] for r in row] for row in got] == [[r["index"] for r in row] for row in ref]


@pytest.mark.parametrize("argv", [
    ["build-distributed", "--k-clusters", "8", "--n-devices", "4", "--cluster-radius", "4.0"],
    ["serve", "--streaming", "--mesh", "4"],
], ids=["build-distributed", "serve-mesh"])
def test_mesh_subcommands_wait_for_parallel(argv, data_file, tmp_path, capsys, monkeypatch):
    """The mesh subcommands, which waited for the port of ``parallel/``,
    now run on a store: ``build-distributed`` (4 CPU slots with ``--device
    cpu``, the reference on 4 of its devices) prints the reference's
    build line and query results (scores within 1e-5, rounded to 6
    digits) and saves a store the streaming index reads; ``serve
    --streaming --mesh 4`` serves the sketch sharded over 4 slots. Without
    ``--device cpu`` a mesh needs that many cards and fails as the
    reference's ``make_mesh`` does, whatever CUDA spelling ``--device``
    gives (``cuda:0`` does not repeat the one card)."""
    data_path, q_path, data = data_file
    store = tmp_path / "store"
    _run(tmain, ["shard-write", str(data_path), "--out", str(store), "--rows-per-shard", "50"],
         capsys)
    if argv[0] == "build-distributed":
        cmd = [argv[0], str(store), *argv[1:], "--query", str(q_path), "--topk", "5"]
        ref = _run(jmain, cmd, capsys)
        got = _run(tmain, cmd + ["--save-store", str(tmp_path / "saved"), *CPU], capsys)
        assert got["n_devices"] == ref["n_devices"] == 4 and got["n_items"] == 120
        assert got["lambda_range"] == pytest.approx(ref["lambda_range"], rel=TOL)
        assert [r["index"] for r in got["query_top"]] == [r["index"] for r in ref["query_top"]]
        np.testing.assert_allclose([r["score"] for r in got["query_top"]],
                                   [r["score"] for r in ref["query_top"]], atol=TOL, rtol=0)
        from matternet_rs_tpu_torch.index.streaming import StreamingIndex

        si = StreamingIndex.load(tmp_path / "saved", device="cpu")
        assert si.search(data[7], 5)[0][0] == got["query_top"][0]["index"] == 7
    else:
        _run(tmain, ["build-streaming", str(store), "--max-clusters", "10", "--radius", "4.0",
                     "--block-rows", "16", "--sample-rows", "120", *CPU], capsys)
        from matternet_rs_tpu_torch import serve as tsv

        served = {}
        monkeypatch.setattr(tsv, "serve", lambda svc, host, port: served.setdefault("svc", svc))
        line = _run(tmain, [argv[0], str(store), *argv[1:], "--port", "0", *CPU], capsys)
        svc = served["svc"]
        try:
            assert line["mesh_devices"] == 4 and line["streaming"] and line["sketch"]
            assert svc.search(data[30], k=3)[0]["index"] == 30
        finally:
            svc.close()
    if not __import__("torch").cuda.is_available():
        for extra in ([], ["--device", "cuda:0"]):
            with pytest.raises(ValueError, match="requested 4 devices, only 0 available"):
                tmain([argv[0], str(store), *argv[1:], *extra])


def test_arguments_follow_the_reference():
    """Every subcommand and option of the reference, with its default;
    ``--device`` added where an index is built or loaded."""
    import argparse

    def parsers(main):
        seen = {}

        def capture(self, args=None, namespace=None):
            seen["p"] = self
            raise SystemExit(0)

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = capture
        try:
            with pytest.raises(SystemExit):
                main([])
        finally:
            argparse.ArgumentParser.parse_args = orig
        sub = next(a for a in seen["p"]._actions if isinstance(a, argparse._SubParsersAction))
        return seen["p"], {name: {a.dest: a.default for a in p._actions if a.dest != "help"}
                           for name, p in sub.choices.items()}

    (pp, port), (_, ref) = parsers(tmain), parsers(jmain)
    assert pp.prog == "matternet_rs_tpu_torch" and set(port) == set(ref)
    loads = {"build", "search", "serve", "build-distributed", "build-streaming",
             "search-streaming"}
    for name in ref:
        want = dict(ref[name], **({"device": None} if name in loads else {}))
        assert {k: v for k, v in port[name].items() if k != "fn"} == \
            {k: v for k, v in want.items() if k != "fn"}, name


def test_serve_subprocess_answers_as_the_checkpoint(data_file, tmp_path, capsys):
    from matternet_rs_tpu_torch.storage import parquet as tpq

    data_path, _, data = data_file
    out = tmp_path / "idx"
    _run(tmain, ["build", str(data_path), "--out", str(out), "--name", "s",
                 "--max-clusters", "10", "--radius", "4.0", *CPU], capsys)
    aspace, gl = tpq.load_arrowspace(out, "s", device="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "matternet_rs_tpu_torch", "serve", str(out), "--name", "s",
         "--port", str(port), *CPU],
        cwd=str(REPO), env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        deadline, healthy = time.monotonic() + 120, False
        while not healthy and time.monotonic() < deadline:
            assert proc.poll() is None, "serve exited"
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=2) as r:
                    healthy = json.loads(r.read())["status"] == "ok"
            except OSError:
                time.sleep(0.2)
        assert healthy, "serve subprocess never became healthy"
        for i in (7, 30, 77):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/search",
                data=json.dumps({"query": data[i].tolist(), "k": 3, "alpha": 0.6}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                doc = json.loads(r.read())
            ids, sc = aspace.search_batch(data[i], gl, 3, np.float32([0.6]))
            assert [r["index"] for r in doc["results"]] == ids[0].tolist()
            assert [r["score"] for r in doc["results"]] == [float(s) for s in sc[0]]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
