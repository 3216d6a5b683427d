"""``eigen_jl``: the eigenmaps index with its λ space JL-projected
(``with_dims_reduction``). The program's build and search, the state the
comparison reads from it, and the plain reference that judges it
(``reference/eigen_jl.py``): the clustering scan replayed over every raw
row, the projection drawn anew from its seed and set beside the
program's, the r × r graph from the replay's projected centroids, every
item's and query's λ of its projection, the blended scores with the
cosine over the raw rows."""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import check, index
from portbench.modes.eigen import answers  # noqa: F401  (the same top-k of the reference)
from portbench.reference import clustering
from portbench.reference.eigen import Precision
from portbench.reference.eigen_jl import EigenJLIndex, jl_matrix, projected_dim, replay


def build(cfg: dict, X: torch.Tensor):
    """``(aspace, gl, stage seconds)``: ``builder.build`` over ``X`` (a
    float32 device tensor; its host copy drives the clustering scan), with
    the projection's ε as the configuration states it."""
    builder = index.make_builder(cfg, X.device).with_dims_reduction(
        True, float(cfg["projection"]["rp_eps"]))
    aspace, gl = builder.build(X.cpu().numpy(), device_rows=X)
    return aspace, gl, index.stage_seconds(builder)


def state(cfg: dict, aspace, gl) -> dict:
    """What the comparison reads from the program, kept before it is freed:
    λ, the scan's assignments, the projected centroids the graph was built
    from, the graph, and the projection matrix (None without one)."""
    p = aspace.projection
    return {"lambdas": aspace.lambdas.detach().clone(),
            "assignments": np.asarray(aspace.cluster_assignments).copy(),
            "centroids": gl.init_data.T.detach().clone(),
            "laplacian": gl.dense().detach().clone(),
            "projection": None if p is None else p.matrix(aspace.device).detach().clone()}


def _matrix(cfg: dict, n_centroids: int, device) -> torch.Tensor | None:
    """The configuration's JL matrix at the width the rule gives for
    ``n_centroids`` (None where the build makes no projection)."""
    f = int(cfg["shape"]["n_features"])
    r = projected_dim(n_centroids, f, float(cfg["projection"]["rp_eps"]))
    return None if r is None else jl_matrix(int(cfg["projection"]["seed"]), f, r, device)


def reference(cfg: dict, X: torch.Tensor, prog: dict | None, prec: str = "f64") -> EigenJLIndex:
    """The reference over ``X``; ``prog`` (the program's state) settles the
    scan's ambiguous rows and the graph's last neighbours within rounding,
    and its matrix is the one the reference projects with (the judge holds
    it to the draw); without it (the control) the reference projects with
    its own draw, rounded as ``prec`` reads it."""
    b = cfg["builder"]
    p = Precision(prec)
    rep = replay(X, int(b["max_clusters"]), float(b["radius"]), p,
                 follow=None if prog is None else prog["assignments"])
    drawn = _matrix(cfg, len(rep.centroids), X.device)
    if prog is not None and prog["projection"] is not None:
        P = prog["projection"].to(X.device).double()
    elif drawn is not None:
        P = drawn
    else:
        raise ValueError("the configuration's build makes no projection at "
                         f"{len(rep.centroids)} centroids")
    ref = EigenJLIndex(X, rep.centroids, P, cfg["graph"], prec,
                       follow=None if prog is None else prog["laplacian"])
    ref.clustering = rep
    ref.drawn = drawn
    return ref


def reference_state(ref: EigenJLIndex) -> dict:
    """The control's state, in the program's place."""
    return {"lambdas": ref.lambdas.float(), "assignments": ref.clustering.assignments,
            "centroids": ref.nodes.float(), "projection": ref.prec.operand(ref.P).float()}


def projection_readings(ref: EigenJLIndex, P: torch.Tensor | None) -> dict:
    """``jl_dim_mismatch``: 1 where the program's matrix is missing or not
    ``[F, r]`` with ``r`` by the JL rule on the replay's centroid count;
    ``projection_err``: the largest gap between the program's matrix and
    the draw from the configuration's seed, over the draw's largest entry."""
    if P is None or ref.drawn is None or tuple(P.shape) != tuple(ref.drawn.shape):
        return {"jl_dim_mismatch": 1, "projection_err": float("inf")}
    d = ref.drawn
    gap = float((P.to(d.device).double() - d).abs().max()) / float(d.abs().max())
    return {"jl_dim_mismatch": 0, "projection_err": gap}


def judge(cfg: dict, traffic: dict, ref: EigenJLIndex, prog: dict, pool: np.ndarray, win):
    """``(readings, extra)``: the window's answers, every item's λ, the
    clustering's assignments, the projected centroids and the projection,
    against the reference."""
    Qp = torch.from_numpy(pool).to(ref.X.device)
    alpha = float(traffic["alpha"])
    readings = check.judge_answers(lambda a, b: ref.scores(Qp[a:b], alpha), ref.X.shape[0],
                                   win.answers, int(traffic["k"]))
    readings["item_lambda_err"] = float(
        (prog["lambdas"].to(ref.lambdas.device).double() - ref.lambdas.double()).abs().max())
    readings.update(clustering.readings(ref.clustering, prog["assignments"]))
    c = prog["centroids"].to(ref.nodes.device).double()
    readings["centroid_err"] = (float((c - ref.nodes).abs().max()) / float(ref.nodes.abs().max())
                                if c.shape == ref.nodes.shape else float("inf"))
    readings.update(projection_readings(ref, prog["projection"]))
    return readings, {"ambiguous_rows": ref.clustering.ambiguous,
                      "centroids": len(ref.clustering.centroids), "graph_ties": ref.graph_ties,
                      "reduced_dim": int(ref.P.shape[1])}
