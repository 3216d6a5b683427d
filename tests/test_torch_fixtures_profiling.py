"""Port vs reference: the synthetic fixtures (``utils/fixtures.py``, bit
for bit for the same arguments) and the profiling helpers
(``utils/profiling.py``: ``lambda_statistics`` equal keys and values
within 1e-6, ``timed_block_until_ready``, ``device_trace``)."""

import numpy as np
import pytest
import torch

from matternet_rs_tpu.utils import fixtures as jfx
from matternet_rs_tpu.utils import profiling as jprof

from matternet_rs_tpu_torch.utils import fixtures as tfx
from matternet_rs_tpu_torch.utils import profiling as tprof

CASES = [
    ("make_moons_hd", (300, 0.1, 0.05, 12, 3)),
    ("make_moons_hd", (7, 0.0, 0.2, 3, 0)),
    ("make_gaussian_cliques", (40, 0.3, 9, 8, 4)),
    ("make_gaussian_cliques", (5, 1.0, 0, 3, 1)),
    ("make_gaussian_cliques_multi", (400, 0.3, 7, 6, 2)),
    ("make_gaussian_cliques_multi", (21, 0.5, 4, 1, 8)),
    ("make_cosine_tied_smoothness_dataset", ()),
    ("make_cosine_tied_smoothness_dataset", (5, 3, 4, 6, 0.2, 11)),
    ("make_gaussian_blob", (250, 0.4)),
    ("make_gaussian_hd", (90, 0.3)),
    ("make_energy_test_dataset", (503, 17, 6)),
]


@pytest.mark.parametrize("name,args", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_fixture_is_bit_equal_to_the_reference(name, args):
    ref, got = getattr(jfx, name)(*args), getattr(tfx, name)(*args)
    for r, g in zip(ref if isinstance(ref, tuple) else (ref,), got if isinstance(got, tuple) else (got,)):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert np.array_equal(g, r)


def test_fixtures_define_every_reference_generator():
    def gens(mod):
        return {n for n in vars(mod) if n.startswith("make_")}

    assert gens(jfx) == gens(tfx)


def test_smoothness_dataset_rejects_an_odd_group():
    with pytest.raises(ValueError, match="even"):
        tfx.make_cosine_tied_smoothness_dataset(group_size=3)


@pytest.mark.parametrize("kind", ["tensor", "array", "list"])
def test_lambda_statistics_match(kind):
    lam = np.random.default_rng(4).random(1000).astype(np.float32)
    given = {"tensor": torch.from_numpy(lam), "array": lam, "list": lam.tolist()}[kind]
    ref, got = jprof.lambda_statistics(lam), tprof.lambda_statistics(given)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key] == pytest.approx(ref[key], abs=1e-6), key
    assert got["count"] == 1000


def test_timed_block_until_ready_on_the_cpu():
    x = torch.ones(8)
    for given in (x, [x, x], {"a": x}):
        assert tprof.timed_block_until_ready(given, "ones") >= 0.0


def test_device_trace_writes_a_trace(tmp_path):
    with tprof.device_trace(tmp_path / "trace"):
        torch.ones(64).sum()
    files = list((tmp_path / "trace").iterdir())
    assert [f.name for f in files] == ["trace.json"] and files[0].stat().st_size > 0


def test_profiling_defines_every_reference_helper():
    import inspect

    def public(mod):
        return {n for n, v in vars(mod).items() if not n.startswith("_")
                and (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == mod.__name__}

    assert public(jprof) <= public(tprof), public(jprof) - public(tprof)
