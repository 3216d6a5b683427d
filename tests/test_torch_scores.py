"""The port's scoring rules (``matternet_rs_tpu_torch/ops/scores.py``) at
their edges, against float64 closed forms, on the CPU.

Each rule is a handful of float32 operations, so the closed form is the
float64 expression and the rule must land within two float32 ulps of it;
where a guard, a band or a clamp decides, the value is exact. The guards
and the band compare float32 values against their float32 constants
(``1e-12`` and ``TIE_EPS``), as the CUDA epilogues do with ``1e-12f`` and
``1e-9f``, so the edges are taken at those constants and one float32 step
either side.
"""

import numpy as np
import pytest
import torch

from matternet_rs_tpu_torch.ops import scores

F32 = np.float32


def _f32(x):
    return torch.tensor(np.asarray(x, F32))


def _steps(x):
    """``x`` in float32 and one float32 step below and above it."""
    x = F32(x)
    return [np.nextafter(x, F32(0)), x, np.nextafter(x, F32(np.inf))]


def _close(got, want64, ulps=2):
    got = np.asarray(got, np.float64)
    tol = ulps * np.spacing(np.abs(want64).astype(F32)).astype(np.float64)
    assert np.all(np.abs(got - want64) <= tol), (got, want64)


# ----------------------------------------------------------- guarded cosine
@pytest.mark.parametrize("step", [0, 1, 2], ids=["below", "at", "above"])
@pytest.mark.parametrize("dots", [0.5, -3e-13, 0.0])
def test_guarded_cosine_at_its_floor(step, dots):
    denom = _steps(1e-12)[step]
    got = float(scores.guarded_cosine(_f32([dots]), _f32([denom]))[0])
    if denom > F32(1e-12):
        _close(got, np.float64(F32(dots)) / np.float64(denom))
    else:
        assert got == 0.0


def test_guarded_cosine_broadcasts_and_is_exact_away_from_the_floor():
    rng = np.random.default_rng(1)
    dots = rng.normal(size=(5, 7)).astype(F32)
    denom = rng.uniform(0.1, 3.0, size=(1, 7)).astype(F32)
    got = scores.guarded_cosine(torch.from_numpy(dots), torch.from_numpy(denom)).numpy()
    _close(got, dots.astype(np.float64) / denom.astype(np.float64), ulps=1)


# ------------------------------------------------------- dequantised cosine
@pytest.mark.parametrize("step", [0, 1, 2], ids=["below", "at", "above"])
def test_norm_floor_at_1e_12(step):
    qn = _steps(1e-12)[step]
    got = float(scores.norm_floor(_f32([qn]))[0])
    assert got == max(qn, F32(1e-12))


@pytest.mark.parametrize("dots,mult,qn", [
    (100.0, 0.01, 1.0),          # inside (−1, 1)
    (-57.0, 0.013, 0.9),
    (300.0, 0.01, 1.0),          # past +1: exactly 1
    (-300.0, 0.01, 1.0),         # past −1: exactly −1
    (1.0, 0.01, 1e-13),          # a query norm below the floor: divided by 1e-12, clamped
    (5e-15, 1.0, 1e-12),
    (127.0, 0.0, 1.0),           # a zero row's multiplier: 0
    (-127.0, 0.0, 0.0),
], ids=["inside", "inside-neg", "past+1", "past-1", "qn-below-floor", "qn-at-floor",
        "zero-mult", "zero-mult-zero-qn"])
def test_dequant_cosine_against_the_closed_form(dots, mult, qn):
    got = float(scores.dequant_cosine(_f32([dots]), _f32([mult]),
                                      scores.norm_floor(_f32([qn])))[0])
    want = np.clip(np.float64(F32(dots)) * np.float64(F32(mult))
                   / max(np.float64(F32(qn)), np.float64(F32(1e-12))), -1.0, 1.0)
    if abs(want) == 1.0 or mult == 0.0:
        assert got == want
    else:
        _close(got, want)


# ---------------------------------------------------------------- the blend
@pytest.mark.parametrize("dlam", [0.0, 0.25, 0.999, 1.0, 1.5, 7.0, -1.0, -2.5])
@pytest.mark.parametrize("alpha_kind", ["float", "tensor"])
def test_blend_against_the_closed_form(dlam, alpha_kind):
    """``α·cos + (1 − α)·(1 − min(|Δλ|, 1))``; from ``|Δλ| ≥ 1`` the λ term
    is exactly 0 and the score is the product ``α·cos`` alone."""
    cos, q, alpha = F32(0.3), F32(0.4), 0.7
    lam = F32(q + F32(dlam))
    a = alpha if alpha_kind == "float" else _f32([alpha])
    got = float(scores.blend(_f32([cos]), _f32([lam]), _f32([q]), a)[0])
    d = abs(np.float64(lam) - np.float64(q))
    want = alpha * np.float64(cos) + (1.0 - alpha) * (1.0 - min(d, 1.0))
    if d >= 1.0:
        assert got == float((_f32([cos]) * a)[0])
    _close(got, want, ulps=3)


def test_blend_with_a_python_float_alpha_rounds_one_minus_alpha_from_the_double():
    """A scalar α stays a Python float: ``1 − α`` is taken in double and
    rounded once, which differs from float32 ``1 − f32(α)`` for this α."""
    alpha = 0.8132702392002724
    assert F32(1.0 - alpha) != F32(1.0) - F32(alpha)
    lam, cos = _f32([0.5]), _f32([0.0])                 # λ-similarity 1, cosine 0
    assert float(scores.blend(cos, lam, lam, alpha)[0]) == float(F32(1.0 - alpha))
    assert float(scores.blend(cos, lam, lam, _f32([alpha]))[0]) == float(F32(1.0) - F32(alpha))


# --------------------------------------------------------------- energy
@pytest.mark.parametrize("step", [0, 1, 2], ids=["below", "at", "above"])
@pytest.mark.parametrize("cos", [1.0, 0.25, -1.0])
def test_energy_score_at_the_tie_band(step, cos):
    d = _steps(scores.TIE_EPS)[step]
    got = float(scores.energy_score(_f32([d]), _f32([cos]))[0])
    if d < F32(scores.TIE_EPS):
        _close(got, np.float64(d) + (1.0 - np.float64(F32(cos))) * scores.TIE_EPS)
    else:
        assert got == d


@pytest.mark.parametrize("d", [0.0, 5e-10, 1e-3, 0.75])
def test_energy_score_orders_by_distance_then_cosine(d):
    lam_dist = _f32([d, d])
    s = scores.energy_score(lam_dist, _f32([0.9, 0.2]))
    if d < scores.TIE_EPS:
        assert float(s[0]) < float(s[1])          # the closer cosine ranks first
    else:
        assert float(s[0]) == float(s[1]) == float(F32(d))


@pytest.mark.parametrize("denom", [0.0, 1e-12, 1e-9, 2.5])
def test_energy_cosine_against_the_closed_form(denom):
    got = float(scores.energy_cosine(_f32([0.75]), _f32([denom]))[0])
    _close(got, np.float64(F32(0.75)) / (np.float64(F32(denom)) + 1e-9))


# ------------------------------------------------------- normalised λ column
@pytest.mark.parametrize("raw", [-1.0, 0.2, 0.2000001, 0.5, 2.2, 2.2000003, 9.0])
@pytest.mark.parametrize("stats_kind", ["float", "tensor"])
def test_normalised_against_the_closed_form(raw, stats_kind):
    mn, rng = 0.2, 2.0
    stats = (mn, rng) if stats_kind == "float" else (_f32(mn), _f32(rng))
    got = float(scores.normalised(_f32([raw]), *stats)[0])
    want = np.clip((np.float64(F32(raw)) - np.float64(F32(mn))) / np.float64(F32(rng)), 0.0, 1.0)
    if want in (0.0, 1.0):
        assert got == want
    else:
        _close(got, want, ulps=3)


# ------------------------------------------------------------ the weights α
@pytest.mark.parametrize("alpha", [0.7, 1, np.float32(0.3), np.float64(0.45), np.array(0.55),
                                   torch.tensor(0.6), torch.tensor(0.6, dtype=torch.float64)],
                         ids=["float", "int", "np32", "np64", "np0d", "tensor0d", "tensor0d64"])
def test_alpha_vector_and_param_of_a_scalar(alpha):
    vec = scores.alpha_vector(alpha, 5, "cpu")
    assert vec.dtype == torch.float32 and vec.shape == (5,) and vec.is_contiguous()
    assert torch.equal(vec, torch.full((5,), float(F32(float(alpha))), dtype=torch.float32))
    p = scores.alpha_param(alpha, 5, "cpu")
    if isinstance(alpha, torch.Tensor):
        assert p.ndim == 0 and float(p) == float(F32(float(alpha)))
    else:
        assert isinstance(p, float) and p == float(alpha)


def test_alpha_vector_pads_a_short_vector_and_keeps_a_full_one():
    a = torch.tensor([0.1, 0.9, 0.3])
    assert torch.equal(scores.alpha_vector(a, 5, "cpu"), torch.tensor([0.1, 0.9, 0.3, 0.0, 0.0]))
    assert torch.equal(scores.alpha_vector(a, 3, "cpu"), a)
    col = scores.alpha_param(a, 3, "cpu")
    assert col.shape == (3, 1) and torch.equal(scores.alpha_vector(col, 3, "cpu"), a)
    assert torch.equal(scores.alpha_vector([0.1, 0.9, 0.3], 3, "cpu"), a)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_alpha_param_takes_a_batch_vector_as_a_column(n):
    if n == 3:
        col = scores.alpha_param(np.array([0.1, 0.9, 0.3]), 3, "cpu")
        assert col.shape == (3, 1) and col.dtype == torch.float32
    else:
        with pytest.raises(ValueError, match="alpha vector length"):
            scores.alpha_param([0.5] * n, 3, "cpu")
