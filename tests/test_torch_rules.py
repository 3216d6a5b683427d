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
