"""``energy_jl``: the energymaps index with its λ space JL-projected
(``build_energy`` with ``with_dims_reduction``). The program's build, the
state the comparison reads from it, and the plain reference that judges
it (``reference/energy_jl.py``): the clustering scan replayed over every
raw row, the projection drawn anew from its seed and set beside the
program's, the compression, diffusion and split worked out again from the
replay's projected centroids, the energy graph, the sub-centroids' λ and
every item's and query's λ of its projection, the energy distances with
the cosine over the raw rows."""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import index
from portbench.modes import energy
from portbench.modes.energy import answers  # noqa: F401  (the same top-k of the reference)
from portbench.modes.eigen_jl import _matrix, projection_readings
from portbench.reference import energy as ref_energy
from portbench.reference.eigen import Precision
from portbench.reference.eigen_jl import replay
from portbench.reference.energy_jl import EnergyJLIndex


def build(cfg: dict, X: torch.Tensor):
    """``(aspace, gl, stage seconds)``: ``builder.build_energy`` over ``X``'s
    host copy, with the projection's ε as the configuration states it."""
    builder = index.make_builder(cfg, X.device).with_dims_reduction(
        True, float(cfg["projection"]["rp_eps"]))
    aspace, gl = builder.build_energy(X.cpu().numpy())
    return aspace, gl, index.stage_seconds(builder)


def state(cfg: dict, aspace, gl) -> dict:
    """What the comparison reads from the program, kept before it is freed:
    λ, the scan's assignments, the sub-centroids and their λ, the energy
    graph, and the projection matrix (None without one)."""
    p = aspace.projection
    return {"lambdas": aspace.lambdas.detach().clone(),
            "assignments": np.asarray(aspace.cluster_assignments).copy(),
            "sub_centroids": aspace.sub_centroids.detach().clone(),
            "laplacian": gl.dense().detach().clone(),
            "subcentroid_lambdas": np.asarray(aspace.subcentroid_lambdas, np.float64).copy(),
            "projection": None if p is None else p.matrix(aspace.device).detach().clone()}


def reference(cfg: dict, X: torch.Tensor, prog: dict | None, prec: str = "f64") -> EnergyJLIndex:
    """The reference over ``X``; ``prog`` (the program's state) settles the
    choices within rounding, and its matrix is the one the reference
    projects with (the judge holds it to the draw); without it (the
    control) the reference projects with its own draw, rounded as ``prec``
    reads it."""
    b, p = cfg["builder"], Precision(prec)
    follow = prog is not None
    rep = replay(X, int(b["max_clusters"]), float(b["radius"]), p,
                 follow=prog["assignments"] if follow else None)
    drawn = _matrix(cfg, len(rep.centroids), X.device)
    if follow and prog["projection"] is not None:
        P = prog["projection"].to(X.device).double()
    elif drawn is not None:
        P = drawn
    else:
        raise ValueError("the configuration's build makes no projection at "
                         f"{len(rep.centroids)} centroids")
    nodes = p.matmul(rep.centroids, P).to(p.dtype)
    S, margins = ref_energy.sub_centroids(nodes, cfg["graph"], cfg["energy"], X.shape[0], p,
                                          follow=prog["sub_centroids"] if follow else None)
    ref = EnergyJLIndex(X, S, P, cfg["graph"], prec,
                        follow=prog["laplacian"] if follow else None)
    ref.clustering, ref.margins, ref.drawn = rep, margins, drawn
    return ref


def reference_state(ref: EnergyJLIndex) -> dict:
    """The control's state, in the program's place."""
    return {**energy.reference_state(ref), "projection": ref.prec.operand(ref.P).float()}


def judge(cfg: dict, traffic: dict, ref: EnergyJLIndex, prog: dict, pool: np.ndarray, win):
    """``(readings, extra)``: the energy index's readings (the window's
    answers and their cosine tie-break, every item's and sub-centroid's λ,
    the sub-centroids, the clustering's assignments) and the projection's,
    against the reference."""
    readings, extra = energy.judge(cfg, traffic, ref, prog, pool, win)
    readings.update(projection_readings(ref, prog["projection"]))
    extra["reduced_dim"] = int(ref.P.shape[1])
    return readings, extra
