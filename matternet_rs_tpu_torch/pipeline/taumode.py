"""τ resolved from the λ distribution (twin of the reference's
``pipeline/taumode.py``): median is the upper median ``sorted[n // 2]``,
percentile the sorted value at ``floor((n − 1)·p + 0.5)`` (Rust's
half-away rounding); floor 1e-9. Host numpy, float32 as the reference."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

TAU_FLOOR = 1e-9


@dataclasses.dataclass(frozen=True)
class TauMode:
    mode: str = "median"     # median | mean | fixed | percentile
    param: float = 0.0

    @classmethod
    def median(cls) -> "TauMode":
        return cls("median")

    @classmethod
    def mean(cls) -> "TauMode":
        return cls("mean")

    @classmethod
    def fixed(cls, t: float) -> "TauMode":
        return cls("fixed", float(t))

    @classmethod
    def percentile(cls, p: float) -> "TauMode":
        return cls("percentile", float(p))


def compute_tau(lambdas, mode: TauMode) -> float:
    """The scalar τ of ``lambdas`` (non-finite values left out)."""
    lam = np.asarray(lambdas, np.float32)
    finite = lam[np.isfinite(lam)]
    if finite.size == 0:
        return TAU_FLOOR
    if mode.mode == "fixed":
        t = mode.param
        return max(t, TAU_FLOOR) if math.isfinite(t) else TAU_FLOOR
    if mode.mode == "mean":
        return max(float(finite.mean()), TAU_FLOOR)
    s = np.sort(finite)
    if mode.mode == "median":
        return max(float(s[len(s) // 2]), TAU_FLOOR)
    if mode.mode == "percentile":
        p = min(max(mode.param, 0.0), 1.0)
        return max(float(s[int(np.floor((len(s) - 1) * p + 0.5))]), TAU_FLOOR)
    raise ValueError(f"unknown tau mode {mode.mode!r}")
