"""On the card: each cell runs once, briefly, and comes out correct.
Run there with ``python -m pytest -m gpu portbench/tests/test_portbench_gpu.py``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.harness.manifest import Manifest
from portbench.tests.conftest import ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in Manifest(ROOT).data["workloads"]])
def test_cell_runs_correct_on_the_card(cuda_card, workload):
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed",
                        "2718281828", "--seconds", "2", "--trace", "0"], capture_output=True,
                       text=True, cwd=ROOT, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
