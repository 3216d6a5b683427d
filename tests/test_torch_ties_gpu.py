"""The adversarial exact-tie corpora through the kernels on the card: the
checks of ``chip_smoke.py``'s phase ``ties`` (``chip_smoke.tie_checks``) at
a smaller size, by the normal entry points (``search_batch`` and its
tiers, the ``mask_from`` routes of a mesh slot, the sketch's maxima-first
scan, ``search_fused``, the 4-slot mesh on one card). Each check holds the reference's tie
contract (``tests/test_fuzz_invariants.py``), the kernel route against the
plain route under the near-tie rules of ``utils/parity``, and its kernels'
launches: B and ``subtile_topk`` (both designs), C at k = 200, D in its
three modes, E on f32 and int8 rows, G's scan and merge. Also:
``fused_fast_path``'s shape form routes a CUDA device as the tensor form
did. Every test needs a CUDA card and ``nvcc`` (marker ``gpu``) and skips
without them. This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_ties_gpu.py
"""

import pytest
import torch

import chip_smoke
from matternet_rs_tpu_torch import backend
from matternet_rs_tpu_torch.ops.kernels import tilemax as tmk

pytestmark = pytest.mark.gpu

# 208 tiles: k = 200 takes the chain with kernel C (c = 204 < 208).
N_MAIN = 208 * 2048


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if backend.nvcc_path() is None:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _failed(records):
    return [(r["corpus"], r["k"], r["tier"], r["faults"]) for r in records if not r["ok"]]


@pytest.mark.parametrize("level", chip_smoke.TIE_LEVELS)
def test_tie_corpus_through_every_tier(dev, level):
    """Exact tier at k = 10, 40, 100, 200 and the three rescored tiers at
    k = 10 and 40 on one level's corpus (and, at the first level, the
    ``mask_from`` routes and the sketch scan)."""
    records, counts = chip_smoke.tie_checks(dev, n_main=N_MAIN, levels=(level,), f_wide=(),
                                            mesh_n=None)
    assert _failed(records) == []
    for kname in ("scores_tilemax", "subtile_topk", "gather_subtiles", "tilemax_only", "slab_dots"):
        assert counts[kname] > 0, kname
    radix = {r["k"]: r["radix_rows"] for r in records if "radix_rows" in r}
    assert set(radix) == {k for k in chip_smoke.TIE_KS if tmk.TOPK_MAX_K < k <= tmk.TOPK_MAX_K_WIDE}
    assert min(radix.values()) >= chip_smoke.TIE_B // chip_smoke.TIE_HUB_SHARE
    if level == chip_smoke.TIE_LEVELS[0]:
        assert [r["tier"] for r in records if "pad_rows_win_unmasked" in r] == \
            ["exact", *chip_smoke.TIE_TIERS, "sketch_int8"]
        assert counts["search_fused"] == 1 and counts["search_fused_merge"] == 1


@pytest.mark.parametrize("f", chip_smoke.TIE_F_WIDE)
def test_tie_corpus_in_the_wide_f_envelope(dev, f):
    records, counts = chip_smoke.tie_checks(dev, levels=(), f_wide=(f,), mesh_n=None)
    assert _failed(records) == []
    assert len(records) == 1 + len(chip_smoke.TIE_TIERS)
    assert counts["scores_tilemax"] > 0 and counts["tilemax_only"] > 0 and counts["slab_dots"] > 0


def test_tie_corpus_on_the_four_slot_mesh(dev):
    records, counts = chip_smoke.tie_checks(dev, levels=(), f_wide=(), mesh_n=chip_smoke.TIE_MESH_N)
    assert _failed(records) == []
    assert [r["tier"] for r in records] == ["exact", "bf16x3_rescored", "int8_rescored"]
    assert all(r["pad_rows_win_unmasked"] > 0 for r in records)
    assert counts["scores_tilemax"] == 4 and counts["subtile_topk"] == 4


def test_fused_fast_path_shape_form_routes_a_card_as_the_tensor_form(dev):
    from test_torch_rules import _fused_fast_path_grid

    _fused_fast_path_grid(dev)
