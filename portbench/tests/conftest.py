"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
in a temporary root, cut to a size the CPU runs in seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TINY_N = 16384        # 2√N ≥ 250: the energy build pools no centroid, as at 1M


def copy_bench(dest: Path, n_items: int | None = TINY_N) -> Path:
    """``BENCHMARK.json`` and ``portbench/`` under ``dest``; with
    ``n_items`` every configuration and mix cut to a tiny size."""
    shutil.copytree(BENCH, dest / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    if n_items is not None:
        for p in (dest / "portbench" / "configs").glob("*.json"):
            d = json.loads(p.read_text())
            d["shape"]["n_items"] = n_items
            p.write_text(json.dumps(d))
        for p in (dest / "portbench" / "traffic").glob("*.json"):
            d = json.loads(p.read_text())
            d["pool_queries"] = 256
            d["batch"] = 64
            if "recall_shortfall" in d["limits"]:
                # At 16k rows and 64-query batches the quantised tier misses
                # ≈ 1e-3 of the top-10 (≈ 4e-5 at 1M); a selection fault 1.
                d["limits"]["recall_shortfall"] = 1e-2
            p.write_text(json.dumps(d))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return copy_bench(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cuda_card():
    """Skips unless a CUDA card is present (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
