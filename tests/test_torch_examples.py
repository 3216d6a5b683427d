"""The port's examples (``examples/torch/``) run, on the CPU here."""

import importlib.util
import pathlib

import numpy as np
import pytest

EXAMPLES = sorted((pathlib.Path(__file__).parent.parent / "examples" / "torch").glob("*.py"))


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.stem for p in EXAMPLES])
def test_port_example_runs_on_cpu(path):
    spec = importlib.util.spec_from_file_location(f"torch_example_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(device="cpu")
    assert out is not None and np.all(np.isfinite(out))
