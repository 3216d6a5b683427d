"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is the JSON file its entry names (``file``); a traffic mix
is ``traffic/<traffic>.json``. Code is found by the names those files and
the manifest give, each a module of its own under the benchmark's folder:

``metrics/<metric>.py``   ``read(ctx) -> float | None``, every metric
``modes/<mode>.py``       an index mode: its build, state, reference, judge
``corpora/<law>.py``      ``rows(n, f, generator, device)``: a corpus law
``drivers/<driver>.py``   ``run(call, traffic, pool, seconds, trace, seed, device)``
``entries/<entry>.py``    ``make(aspace, gl, traffic) -> call(Q)``
``work/<kind>.py``        ``unit(traffic, cfg, extra) -> dict | None``

Adding any of them takes new files and new entries, never an edit."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / "portbench"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                cfg = json.loads((self.root / c["file"]).read_text())
                cfg["name"] = name
                return cfg
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        tr = json.loads((self.bench_dir / "traffic" / f"{name}.json").read_text())
        tr["name"] = name
        return tr

    def metrics_of(self, workload: str, section: str) -> list[dict]:
        """The entries of ``section`` ("end_to_end" or "per_layer") that
        ``workload`` reports: those without ``workloads``, and those that
        list it."""
        return [m for m in self.data[section]
                if "workloads" not in m or workload in m["workloads"]]

    def module(self, kind: str, name: str):
        """The module ``<kind>/<name>.py`` of the benchmark's folder."""
        path = self.bench_dir / kind / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {kind}/{name}.py under {self.bench_dir}")
        spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        return self.module("metrics", metric).read


class Cell:
    """One workload with its configuration, traffic mix and the modules
    they name."""

    def __init__(self, man: Manifest, workload: str):
        self.name = workload
        self.wl = man.workload(workload)
        self.cfg = man.config(self.wl["config"])
        self.traffic = man.traffic(self.wl["traffic"])
        self.mode = man.module("modes", self.cfg["mode"])
        self.law = man.module("corpora", self.cfg["corpus"]["law"])
        self.driver = man.module("drivers", self.traffic["driver"])
        self.entry = man.module("entries", self.traffic["entry"])
        kind = self.traffic.get("work")
        self.work = man.module("work", kind) if kind else None
