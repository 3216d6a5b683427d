"""``eigen``: the eigenmaps index. The program's build, the state the
comparison reads from it, and the plain reference that judges it: the
clustering scan replayed over every row, the graph from the replay's own
centroids, every item's and query's λ, the blended scores."""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import check, index
from portbench.reference import clustering
from portbench.reference.eigen import EigenIndex, Precision


def build(cfg: dict, X: torch.Tensor):
    """``(aspace, gl, stage seconds)``: ``builder.build`` over ``X`` (a
    float32 device tensor; its host copy drives the clustering scan)."""
    builder = index.make_builder(cfg, X.device)
    aspace, gl = builder.build(X.cpu().numpy(), device_rows=X)
    return aspace, gl, index.stage_seconds(builder)


def state(cfg: dict, aspace, gl) -> dict:
    """What the comparison reads from the program, kept before it is freed."""
    return {"lambdas": aspace.lambdas.detach().clone(),
            "assignments": np.asarray(aspace.cluster_assignments).copy(),
            "centroids": gl.init_data.T.detach().clone(),
            "laplacian": gl.dense().detach().clone()}


def reference(cfg: dict, X: torch.Tensor, prog: dict | None, prec: str = "f64") -> EigenIndex:
    """The reference over ``X``; ``prog`` (the program's state) settles the
    scan's ambiguous rows, ``prec="tf32"`` makes the control."""
    b = cfg["builder"]
    rep = clustering.replay(X, int(b["max_clusters"]), float(b["radius"]), Precision(prec),
                            follow=None if prog is None else prog["assignments"])
    ref = EigenIndex(X, rep.centroids, cfg["graph"], prec,
                     follow=None if prog is None else prog["laplacian"])
    ref.clustering = rep
    return ref


def reference_state(ref: EigenIndex) -> dict:
    """The control's state, in the program's place."""
    return {"lambdas": ref.lambdas.float(), "assignments": ref.clustering.assignments,
            "centroids": ref.clustering.centroids.float()}


def answers(ref: EigenIndex, traffic: dict, pool: np.ndarray) -> list:
    """The reference's own top-k of every pool query (the control's)."""
    Qp, k, out = torch.from_numpy(pool).to(ref.X.device), int(traffic["k"]), []
    for q0 in range(0, len(pool), 256):
        v, i = torch.topk(ref.scores(Qp[q0:q0 + 256], float(traffic["alpha"])), k, dim=1)
        out.append((np.arange(q0, q0 + len(v)), i.cpu().numpy(), v.double().cpu().numpy()))
    return out


def judge(cfg: dict, traffic: dict, ref: EigenIndex, prog: dict, pool: np.ndarray, win):
    """``(readings, extra)``: the window's answers, every item's λ, the
    clustering's assignments and centroids, against the reference."""
    Qp = torch.from_numpy(pool).to(ref.X.device)
    alpha = float(traffic["alpha"])
    readings = check.judge_answers(lambda a, b: ref.scores(Qp[a:b], alpha), ref.X.shape[0],
                                   win.answers, int(traffic["k"]))
    readings["item_lambda_err"] = float(
        (prog["lambdas"].to(ref.lambdas.device).double() - ref.lambdas.double()).abs().max())
    readings.update(clustering.readings(ref.clustering, prog["assignments"], prog["centroids"]))
    return readings, {"ambiguous_rows": ref.clustering.ambiguous,
                      "centroids": len(ref.clustering.centroids), "graph_ties": ref.graph_ties}
