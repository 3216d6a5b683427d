"""Rules of the port: what it imports, where its entry points run, and
that a kernel wrapper never computes on the CPU for a tensor that is not
on the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import matternet_rs_tpu_torch
from matternet_rs_tpu_torch import backend, convert
from matternet_rs_tpu_torch.builder import ArrowSpaceBuilder
from matternet_rs_tpu_torch.core import ArrowSpace
from matternet_rs_tpu_torch.ops import kernels
from matternet_rs_tpu_torch.ops.kernels import _cuda
from matternet_rs_tpu_torch.ops import csr as tcsr
from matternet_rs_tpu_torch.ops import eigensolver as teig
from matternet_rs_tpu_torch.ops.kernels import rescored as trsk
from matternet_rs_tpu_torch.ops.kernels import search_fused as tsf
from matternet_rs_tpu_torch.ops.kernels import spmv_ell as tfk
from matternet_rs_tpu_torch.ops.kernels import taumode as ttk
from matternet_rs_tpu_torch.ops.kernels import tilemax as ttmk

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_DIR = pathlib.Path(matternet_rs_tpu_torch.__file__).parent
# _build/ is git-ignored build output (it may hold an unpacked checkout).
PORT_FILES = sorted(p for p in PORT_DIR.rglob("*.py")
                    if "_build" not in p.relative_to(PORT_DIR).parts)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py"], ids=lambda p: p.name
)
def test_no_jax_and_no_reference_package_imports(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root != "jax", f"{path.name} imports {name}"
        assert root != "matternet_rs_tpu", f"{path.name} imports {name}"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points take it")


def test_entry_points_raise_without_cuda_and_without_cpu_request():
    _no_cuda()
    X = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ArrowSpaceBuilder()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ArrowSpace.from_items(X)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.arrowspace_from_arrays(X, np.zeros(8), np.eye(4), normalized=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.graph_from_arrays(np.eye(4, dtype=np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.ell_from_arrays(np.zeros((4, 1), np.int32), np.zeros((4, 1)), np.zeros(4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcsr.SparseGraph.from_edges([(0, 1, 1.0)], 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcsr.SparseGraph.from_dense(np.eye(4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teig.lobpcg_smallest(np.eye(4, dtype=np.float32), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend.resolve_device("cuda")
    assert backend.resolve_device("cpu").type == "cpu"
    assert ArrowSpaceBuilder(device="cpu").device.type == "cpu"


def test_kernel_library_refuses_without_a_card():
    _no_cuda()
    for name in _cuda.SIGNATURES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _cuda.library(name)


def test_kernel_wrappers_raise_for_non_cpu_tensors_without_a_card():
    """A tensor that does not lie on the CPU (here: on the meta device)
    sends each wrapper to its kernel, which is refused; nothing is
    computed on the CPU and no launch is counted."""
    _no_cuda()
    kernels.reset_launches()
    m = dict(device="meta", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttk.taumode_lambdas_fused(torch.empty(40, 8, **m), torch.empty(8, 8, **m),
                                  torch.empty(40, **m))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttmk.scores_and_tilemax(
            torch.empty(4096, 8, **m), torch.empty(4096, **m), torch.empty(4096, **m),
            torch.empty(4, 8, **m), torch.empty(4, **m), torch.empty(4, **m),
        )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttmk.gather_subtiles(torch.empty(4, 1024, **m),
                             torch.zeros(4, 2, dtype=torch.int64, device="meta"), 256)
    for dtype in (torch.bfloat16, torch.int8, torch.float32):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trsk.tilemax_only(
                torch.empty(4096, 8, device="meta", dtype=dtype), torch.empty(4096, **m),
                torch.empty(4096, **m), torch.empty(4, 8, **m), torch.empty(4, **m),
                torch.empty(4, **m), subs=16,
            )
    for dtype in (torch.float32, torch.int8):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trsk.slab_dots(torch.empty(1024, 8, device="meta", dtype=dtype), torch.empty(4, 8, **m),
                           torch.zeros(4, 2, dtype=torch.int64, device="meta"), 128)
    idx = torch.zeros(64, 3, dtype=torch.int32, device="meta")
    for d in (None, torch.empty(64, **m)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfk.spmv_ell(idx, torch.empty(64, 3, **m), torch.empty(64, 5, **m), d, checked=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcsr.spmv_ell_scan(idx, torch.empty(64, 3, **m), torch.empty(64, 5, **m), checked=True)
    fused = (torch.empty(600, 8, **m), torch.empty(600, **m), torch.empty(4, 8, **m),
             torch.empty(4, **m))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsf.search_fused(*fused, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsf.scan_partials(*fused, 10, 0.7, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsf.merge_partials(torch.empty(4, 2, 16, **m),
                           torch.zeros(4, 2, 16, dtype=torch.int32, device="meta"), 10)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


def test_backend_info_reports_cuda_state():
    info = backend.backend_info()
    assert info["cuda_available"] == torch.cuda.is_available()
    assert set(info) >= {"device_name", "device_count", "nvcc", "torch"}


def test_full_f32_policy_is_set():
    from matternet_rs_tpu_torch.ops import _mm  # noqa: F401  (sets the policy)

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


# -- The public API against the reference's: recall_target and the root's names.

@pytest.fixture(scope="module")
def small_index():
    from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

    X = make_energy_test_dataset(400, 16, seed=3).astype(np.float32)
    aspace, _ = (ArrowSpaceBuilder(device="cpu").with_lambda_graph(1.0, 6)
                 .with_sparsity_check(False).with_cluster_params(max_clusters=24, radius=6.0)
                 .with_seed(5).with_sampling(None).build(X))
    return X, aspace


def _same_hits(a, b):
    return [i for i, _ in a] == [i for i, _ in b] and np.array_equal(
        np.array([s for _, s in a], np.float32), np.array([s for _, s in b], np.float32))


@pytest.mark.parametrize("quantized", [False, True])
def test_arrowspace_search_lambda_aware_takes_recall_target(small_index, quantized):
    """``recall_target`` by keyword and in its positional place (after
    ``approx``, before ``quantized``) changes nothing: ``approx`` selects
    exactly."""
    X, aspace = small_index
    q, lam = X[17], float(aspace.lambdas[17])
    plain = aspace.search_lambda_aware(q, lam, 5, 0.7, False, quantized=quantized)
    for approx in (False, True):
        base = aspace.search_lambda_aware(q, lam, 5, 0.7, approx, quantized=quantized)
        assert _same_hits(base, plain)
        for target in (0.5, 0.95, 0.999):
            by_name = aspace.search_lambda_aware(q, lam, 5, alpha=0.7, approx=approx,
                                                 recall_target=target, quantized=quantized)
            by_place = aspace.search_lambda_aware(q, lam, 5, 0.7, approx, target, quantized)
            assert _same_hits(by_name, base) and _same_hits(by_place, base)
    assert plain[0][0] == 17


def test_ops_search_lambda_aware_takes_recall_target(small_index):
    from matternet_rs_tpu_torch.ops import search as tso

    X, aspace = small_index
    args = (aspace.data, aspace.norms, aspace.lambdas, torch.from_numpy(X[:6]), aspace.lambdas[:6], 7)
    idx, top = tso.search_lambda_aware(*args, 0.7, False)
    for approx in (False, True):
        for got in (tso.search_lambda_aware(*args, 0.7, approx, 0.8),
                    tso.search_lambda_aware(*args, alphas=0.7, approx=approx, recall_target=0.99)):
            assert torch.equal(got[0], idx) and torch.equal(got[1], top)


def test_search_lambda_aware_signatures_follow_the_reference():
    import inspect

    from matternet_rs_tpu.core import ArrowSpace as RefArrowSpace
    from matternet_rs_tpu.ops import search as jso
    from matternet_rs_tpu_torch.ops import search as tso

    port = list(inspect.signature(ArrowSpace.search_lambda_aware).parameters)
    assert port == list(inspect.signature(RefArrowSpace.search_lambda_aware).parameters)
    assert port[-3:] == ["approx", "recall_target", "quantized"]
    assert inspect.signature(ArrowSpace.search_lambda_aware).parameters["recall_target"].default == 0.95
    # The batched port names its query arguments in the plural; the order of
    # what follows k is the reference's.
    port_ops = inspect.signature(tso.search_lambda_aware).parameters
    ref_ops = inspect.signature(jso.search_lambda_aware).parameters
    assert list(port_ops)[-3:] == ["alphas", "approx", "recall_target"]
    assert list(ref_ops)[-3:] == ["alpha", "approx", "recall_target"]
    assert port_ops["recall_target"].default == ref_ops["recall_target"].default == 0.95


def test_package_root_exports_what_the_reference_exports(monkeypatch):
    import logging
    import types

    import matternet_rs_tpu as ref
    from matternet_rs_tpu_torch import eigenmaps as tem

    port = matternet_rs_tpu_torch
    for name in ("TAU_FLOOR", "backend", "eigenmaps", "init", "__version__"):
        assert name in port.__all__, name
    assert port.TAU_FLOOR == ref.TAU_FLOOR == 1e-10
    assert port.__version__ == ref.__version__
    assert port.backend is backend and isinstance(port.backend, types.ModuleType)
    assert port.eigenmaps is tem and callable(port.eigenmaps.eigenmaps)
    calls = []
    monkeypatch.setattr(logging, "basicConfig", lambda **kw: calls.append(kw))
    port.init()
    ref.init()
    port.init(level="DEBUG")
    ref.init(level="DEBUG")
    assert calls[0] == calls[1] and calls[0]["level"] == "INFO"
    assert calls[2] == calls[3] and calls[2]["level"] == "DEBUG"


@pytest.mark.parametrize("name", ["energymaps", "motives", "subgraphs", "sparsification"])
def test_energy_era_modules_are_submodules_with_the_reference_names(name):
    """``from matternet_rs_tpu_torch import <name>`` works as in the
    reference, and the port's module defines every public class and
    function the reference's defines."""
    import importlib
    import inspect

    ref = importlib.import_module(f"matternet_rs_tpu.{name}")
    port = importlib.import_module(f"matternet_rs_tpu_torch.{name}")
    assert getattr(__import__("matternet_rs_tpu_torch", fromlist=[name]), name) is port

    def public(mod):
        return {n for n, v in vars(mod).items() if not n.startswith("_")
                and (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == mod.__name__}

    assert public(ref) <= public(port), public(ref) - public(port)


def test_energy_entry_points_raise_without_cuda_and_without_cpu_request():
    _no_cuda()
    from matternet_rs_tpu_torch import energymaps

    c = np.random.default_rng(0).normal(size=(20, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        energymaps.optical_compress_centroids(c, 4, 0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.arrowspace_from_arrays(
            c, np.zeros(20), np.eye(8), normalized=False, sub_centroids=c[:3],
            subcentroid_lambdas=np.zeros(3), centroid_map=np.zeros(20, np.int64))
    assert energymaps.optical_compress_centroids(c, 4, 0.1, device="cpu").shape == (4, 8)


# -- The builder's fluent methods, the storage functions, pyarrow.

def _params(fn):
    import inspect

    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]


def test_builder_fluent_methods_follow_the_reference():
    from matternet_rs_tpu.builder import ArrowSpaceBuilder as RefBuilder

    ref = [n for n in dir(RefBuilder) if n.startswith("with_")]
    assert ref and ref == [n for n in dir(ArrowSpaceBuilder) if n.startswith("with_")]
    for name in ref:
        assert _params(getattr(ArrowSpaceBuilder, name)) == _params(getattr(RefBuilder, name)), name
    for name in ("build_for_persistence", "build_energy"):
        assert _params(getattr(ArrowSpaceBuilder, name)) == _params(getattr(RefBuilder, name)), name
    for field in ("deterministic_clustering", "use_dims_reduction", "rp_eps"):
        assert getattr(ArrowSpaceBuilder, field) == getattr(RefBuilder, field), field


@pytest.mark.parametrize("module", ["parquet", "shards"])
def test_storage_functions_follow_the_reference(module):
    """The reference's parameters in its order; the port may add ``device``
    at the end (where it places what it loads)."""
    import importlib
    import inspect

    ref = importlib.import_module(f"matternet_rs_tpu.storage.{module}")
    port = importlib.import_module(f"matternet_rs_tpu_torch.storage.{module}")
    names = [n for n, f in vars(ref).items() if inspect.isfunction(f) and f.__module__ == ref.__name__
             and not n.startswith("_")]
    assert names
    for name in names:
        want, got = _params(getattr(ref, name)), _params(getattr(port, name))
        assert got[:len(want)] == want, name
        assert [n for n, _ in got[len(want):]] in ([], ["device"]), name


def test_package_imports_without_pyarrow():
    """``pyarrow`` is imported by ``storage.parquet`` alone: the package, the
    builder and the shard store import (and build) where it cannot."""
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['pyarrow'] = None\n"
        "import numpy as np\n"
        "import matternet_rs_tpu_torch as m\n"
        "from matternet_rs_tpu_torch.storage import shards\n"
        "from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset\n"
        "X = make_energy_test_dataset(300, 8, seed=1).astype(np.float32)\n"
        "m.ArrowSpaceBuilder(device='cpu').with_seed(3).build(X)\n"
        "try:\n"
        "    import matternet_rs_tpu_torch.storage.parquet\n"
        "except ImportError:\n"
        "    print('parquet needs pyarrow')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "parquet needs pyarrow" in out.stdout


def test_load_arrowspace_and_projection_raise_without_a_card(tmp_path):
    _no_cuda()
    from matternet_rs_tpu_torch.reduction import ImplicitProjection
    from matternet_rs_tpu_torch.storage import parquet as tpq
    from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset

    X = make_energy_test_dataset(300, 8, seed=1).astype(np.float32)
    b = ArrowSpaceBuilder(device="cpu").with_seed(3)
    aspace, gl = b.build(X)
    tpq.save_checkpoint(aspace, gl, b, tmp_path, "ck")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpq.load_arrowspace(tmp_path, "ck")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpq.load_graph_laplacian(tmp_path, "ck")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ImplicitProjection(8, 4, 1).matrix()
    assert tpq.load_arrowspace(tmp_path, "ck", device="cpu")[0].device.type == "cpu"
