"""Nothing the benchmark loads is JAX or the JAX package, and the
reference loads nothing of the program (top-level names compared whole)."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "matternet_rs_tpu"}

LOAD_ALL = """
import json, sys
sys.path.insert(0, {root!r})
from pathlib import Path
import portbench.run, portbench.control
from portbench.harness import cell, check, gen, index, manifest, roofline, stats, trace, window
import portbench.reference.clustering, portbench.reference.eigen, portbench.reference.energy
man = manifest.Manifest()
for kind in ("metrics", "modes", "corpora", "drivers", "entries", "work"):
    for p in sorted((man.bench_dir / kind).glob("*.py")):
        man.module(kind, p.stem)
for w in man.data["workloads"]:
    manifest.Cell(man, w["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.clustering, portbench.reference.eigen, portbench.reference.energy
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set[str]:
    r = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], capture_output=True,
                       text=True, cwd=ROOT, timeout=300, check=True)
    return set(json.loads(r.stdout.splitlines()[-1]))


def test_harness_traffic_metrics_and_reference_load_no_jax():
    names = _top_level(LOAD_ALL)
    assert not names & FORBIDDEN
    assert "portbench" in names


def test_reference_loads_nothing_of_the_program():
    names = _top_level(LOAD_REFERENCE)
    assert "matternet_rs_tpu_torch" not in names and not names & FORBIDDEN


def test_a_whole_run_loads_no_jax(tmp_path):
    """A cell run on the CPU through the program, then the run's own check."""
    from portbench.tests.conftest import copy_bench

    root = copy_bench(tmp_path)
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from portbench.harness.cell import run_cell, forbidden_modules
out = run_cell("eigen-blobs1m.exact-b256", 3, 0.2, False, "cpu", root={str(root)!r})
assert out["correct"], out
print(forbidden_modules())
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       timeout=300, check=True)
    assert r.stdout.splitlines()[-1] == "[]"
