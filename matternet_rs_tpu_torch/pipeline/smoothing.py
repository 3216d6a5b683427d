"""Stage B2: Kalman RTS smoothing along the MST order (twin of the
reference's ``pipeline/smoothing.py``).

A scalar-per-feature diagonal Kalman filter over the C centroids in MST
traversal order, transition Identity, Damped(α) or TrunkAware (Q scaled on
trunk edges), then the backward RTS pass. The reference's two
``lax.scan``s become two step loops of F-wide float32 vectors on the
state's device, the same elementwise operations in the same order; the
parts that do not depend on the recursion (the observation noise, the RTS
gains and their means) are taken for all steps at once. At C ≈ 10,000 the
loops are bound by the launches of their small steps. Output rows are in
MST order (row t ↔ centroid ``order[t]``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from matternet_rs_tpu_torch.pipeline.centroid import CentroidState
from matternet_rs_tpu_torch.pipeline.mst import MSTOutput

IDENTITY = "identity"
DAMPED = "damped"
TRUNK_AWARE = "trunk_aware"


@dataclasses.dataclass(frozen=True)
class SmoothingConfig:
    process_noise: float = 0.01
    observation_noise: float = 0.1
    transition_model: str = IDENTITY
    damping: float = 1.0              # α for Damped
    trunk_factor: float = 1.0         # Q multiplier on trunk edges
    variance_floor: float = 1e-6
    variance_ceiling: float = 1e3

    @classmethod
    def conservative(cls) -> "SmoothingConfig":
        return cls(process_noise=0.1, observation_noise=0.01)

    @classmethod
    def aggressive(cls) -> "SmoothingConfig":
        return cls(process_noise=0.001, observation_noise=1.0)

    @classmethod
    def trunk_aware(cls, trunk_factor: float) -> "SmoothingConfig":
        return cls(transition_model=TRUNK_AWARE, trunk_factor=trunk_factor)


@dataclasses.dataclass
class KalmanOutput:
    smoothed_means: torch.Tensor        # [C, F] in MST order
    smoothed_variances: torch.Tensor    # [C, F]
    counts: torch.Tensor                # [C], in MST order
    filtered_means: torch.Tensor
    filtered_variances: torch.Tensor
    smoothing_gains: np.ndarray         # [C-1] mean RTS gain per transition
    variance_reduction: float
    order: np.ndarray                   # MST order (row t ↔ order[t])

    def summary(self) -> str:
        n = len(self.smoothing_gains)
        mean_gain = float(self.smoothing_gains.mean()) if n else 0.0
        return (f"Kalman: variance_reduction={self.variance_reduction * 100.0:.2f}%, "
                f"gains_mean={mean_gain:.4f} (over {n} transitions)")

    def to_centroid_state(self) -> CentroidState:
        return CentroidState(means=self.smoothed_means, variances=self.smoothed_variances,
                             counts=self.counts)


def _f32(v: float) -> float:
    """``v`` rounded to float32, as the reference's ``jnp.float32``."""
    return float(np.float32(v))


def rts_smooth(means_o: torch.Tensor, vars_o: torch.Tensor, trunk_flags: np.ndarray, model: str,
               alpha: float, trunk_factor: float, q: float, r: float, vfloor: float,
               vceil: float):
    """Forward filter and backward RTS pass over ``[C, F]`` rows already in
    MST order; ``trunk_flags[t]``: step t is a trunk edge. Returns
    ``(filtered_means, filtered_vars, smoothed_means, smoothed_vars,
    gains [C-1])``."""
    c = means_o.shape[0]
    q, r, vfloor, vceil = _f32(q), _f32(r), _f32(vfloor), _f32(vceil)
    a = _f32(alpha)
    a2 = float(np.float32(a) * np.float32(a))
    # Q of each step's transition (float32 scalars, as the reference's).
    q_eff = [_f32(np.float32(q) * np.float32(trunk_factor)) if model == TRUNK_AWARE and t
             else q for t in trunk_flags]
    r_obs = torch.clamp(torch.clamp(vars_o, vfloor, vceil) + r, min=vfloor)
    fm, fv = torch.empty_like(means_o), torch.empty_like(vars_o)
    xp, pp = torch.empty_like(means_o), torch.empty_like(vars_o)
    x, p = means_o[0], torch.clamp(vars_o[0] + q, vfloor, vceil)
    fm[0], fv[0] = x, p
    for t in range(1, c):
        if model == DAMPED:
            x_pred, p_pred = a * x, a2 * p + q
        else:
            x_pred, p_pred = x, p + q_eff[t]
        p_pred = torch.clamp(p_pred, vfloor, vceil)
        k = torch.clamp(p_pred / (p_pred + r_obs[t]), 0.0, 1.0)
        x = x_pred + k * (means_o[t] - x_pred)
        p = torch.clamp((1.0 - k) * p_pred, vfloor, vceil)
        fm[t], fv[t], xp[t], pp[t] = x, p, x_pred, p_pred
    # Backward pass, t = C-2 .. 0; the gains depend on the forward pass only.
    p_next = pp[1:]
    j = torch.where(p_next > vfloor, torch.clamp(fv[:-1] / torch.clamp(p_next, min=vfloor), 0.0, 1.0),
                    torch.zeros_like(p_next))
    jj = j * j
    sm, sv = torch.empty_like(fm), torch.empty_like(fv)
    x_sm, p_sm = fm[-1], fv[-1]
    sm[-1], sv[-1] = x_sm, p_sm
    for t in range(c - 2, -1, -1):
        x_sm = fm[t] + j[t] * (x_sm - xp[t + 1])
        p_sm = torch.clamp(fv[t] + jj[t] * (p_sm - pp[t + 1]), vfloor, vceil)
        sm[t], sv[t] = x_sm, p_sm
    return fm, fv, sm, sv, torch.mean(j, dim=1)


class SmoothingStage:
    def __init__(self, config: SmoothingConfig | None = None):
        self.config = config or SmoothingConfig()

    def execute(self, state: CentroidState, mst_output: MSTOutput) -> KalmanOutput:
        cfg = self.config
        order = np.asarray(mst_output.centroid_order, np.int64)
        c = len(order)
        ot = torch.from_numpy(order).to(state.means.device)
        means_o, vars_o, counts_o = state.means[ot], state.variances[ot], state.counts[ot]
        trunk_flags = np.zeros(c, bool)
        for t in range(1, c):
            trunk_flags[t] = (int(order[t - 1]), int(order[t])) in mst_output.trunk_edges
        fm, fv, sm, sv, gains = rts_smooth(
            means_o, vars_o, trunk_flags, cfg.transition_model, cfg.damping, cfg.trunk_factor,
            cfg.process_noise, cfg.observation_noise, cfg.variance_floor, cfg.variance_ceiling)
        raw_var_mean, smoothed_var_mean = torch.stack(
            [torch.mean(state.variances), torch.mean(sv)]).cpu().tolist()
        variance_reduction = ((raw_var_mean - smoothed_var_mean) / raw_var_mean
                              if raw_var_mean > 0 else 0.0)
        return KalmanOutput(
            smoothed_means=sm, smoothed_variances=sv, counts=counts_o,
            filtered_means=fm, filtered_variances=fv, smoothing_gains=gains.cpu().numpy(),
            variance_reduction=variance_reduction, order=order,
        )
