"""The manifest, the files it names, and that new ones are found by name."""

from __future__ import annotations

import hashlib
import json
import shutil

import pytest

from portbench.harness.manifest import Cell, Manifest
from portbench.tests.conftest import ROOT, copy_bench

NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")


def test_manifest_names_files_that_exist():
    root = ROOT
    man = Manifest(root)
    d = man.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert d["paths"] == ["portbench"]
    e2e = {m["name"] for m in d["end_to_end"]}
    assert "setup_s" in e2e
    for w in d["workloads"]:
        Cell(man, w["name"])           # its config, traffic and every module they name
        assert w["chips"] == 1
        assert set(w["name"]) <= NAME_CHARS and len(w["why"]) <= 200
        assert [m for m in man.metrics_of(w["name"], "end_to_end") if m["name"] != "setup_s"]
        assert man.metrics_of(w["name"], "per_layer")
    for m in d["end_to_end"] + d["per_layer"]:
        assert callable(man.reader(m["name"]))
    for m in d["per_layer"]:
        assert m["moves"] in e2e
        # Every cell that reports the metric reports what it moves.
        for w in m.get("workloads", [x["name"] for x in d["workloads"]]):
            assert m["moves"] in {x["name"] for x in man.metrics_of(w, "end_to_end")}
    for c in d["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert all(key in cfg for key in c["reduced"])
        assert c["file"].startswith("portbench/")


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metric_entries_keep_to_the_manifest_rules(section):
    d = Manifest(ROOT).data
    for m in d[section]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves", "workloads"}
        assert m["better"] in ("lower", "higher")
        if section == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*")) if p.is_file()}


NEW_FILES = {
    "corpora/dummy_law.py": """import torch


def rows(n, f, gen, device):
    out = 0.8 * (2.0 * torch.rand((n, f), generator=gen, device=device) - 1.0)
    out[:, 0] += 10.0 * torch.randint(0, 3, (n,), generator=gen, device=device).float()
    return out
""",
    "modes/dummy_mode.py": "from portbench.modes.eigen import answers, build, judge, reference, "
                           "reference_state, state  # noqa: F401\n",
    "drivers/dummy_driver.py": """from portbench.drivers.closed_batch import run as closed


def run(call, traffic, pool, seconds, trace, seed, device):
    return closed(call, dict(traffic, batch=traffic["batch"] // 2), pool, seconds, trace, seed,
                  device)
""",
    "entries/dummy_entry.py": """def make(aspace, gl, traffic):
    return lambda Q: aspace.search_batch(Q, gl, int(traffic["k"]), float(traffic["alpha"]))
""",
    "work/dummy_work.py": """from portbench.work.exact_scan import count


def unit(traffic, cfg, extra):
    return count(int(traffic["batch"]) // 2, int(cfg["shape"]["n_items"]),
                 int(cfg["shape"]["n_features"]), int(traffic["k"]))
""",
    "metrics/dummy.units.py": "def read(ctx):\n    return float(ctx['units'])\n",
    "metrics/dummy.batch_rows.py": "def read(ctx):\n"
                                   "    return float(ctx['window'].completed / ctx['units'])\n",
}


def test_new_files_are_found_by_name(tmp_path):
    """A configuration with its own corpus law and index mode, a traffic mix
    with its own driver, entry and unit of work, an end-to-end and a
    per-layer metric, all added as new files and new entries, run without
    an edit to any file already there."""
    root = copy_bench(tmp_path)
    before = _digest(root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "eigen-blobs1m.json").read_text())
    cfg.update(mode="dummy_mode", corpus={"law": "dummy_law"})
    cfg["shape"]["n_items"] = 4096
    (pb / "configs" / "dummy-cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "exact-b256.json").read_text())
    mix.update(batch=64, driver="dummy_driver", entry="dummy_entry", work="dummy_work")
    (pb / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    for rel, text in NEW_FILES.items():
        (pb / rel).write_text(text)
    cell = "dummy-cfg.dummy-mix"
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "dummy-cfg", "source": "https://example.org/dummy",
                           "file": "portbench/configs/dummy-cfg.json", "reduced": [],
                           "why": "a dummy"})
    man["workloads"].append({"name": cell, "config": "dummy-cfg", "traffic": "dummy-mix",
                             "chips": 1, "why": "a dummy"})
    for m in man["end_to_end"]:
        if m["name"] == "search_qps":
            m["workloads"].append(cell)
    man["end_to_end"].append({"name": "dummy.batch_rows", "unit": "queries", "better": "higher",
                              "bound": 0.01, "source": "host_clock", "workloads": [cell]})
    man["per_layer"].append({"name": "dummy.units", "unit": "batches", "better": "higher",
                             "source": "program_counter", "layer": "kernels",
                             "moves": "search_qps", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    from portbench.harness.cell import run_cell

    out = run_cell(cell, 7, 0.3, True, "cpu", root=root)
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["dummy.units"]["value"] >= 1
    out = run_cell(cell, 7, 0.3, False, "cpu", root=root)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"setup_s", "search_qps", "dummy.batch_rows"}
    assert out["metrics"]["dummy.batch_rows"]["value"] == 32      # the driver's half batches
    new = {p for p in _digest(root) if p not in before}
    assert _digest(root).items() >= before.items()
    assert {str(p) for p in new if "__pycache__" not in str(p)} == {
        "portbench/configs/dummy-cfg.json", "portbench/traffic/dummy-mix.json",
        *(f"portbench/{rel}" for rel in NEW_FILES)}
    shutil.rmtree(root)
