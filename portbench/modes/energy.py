"""``energy``: the energymaps index. The program's build, the state the
comparison reads from it, and the plain reference that judges it: the
clustering scan replayed over every row, the compression, diffusion and
split worked out again from the replay's centroids, the energy graph, the
sub-centroids' and every item's and query's λ, the energy distances."""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import check, index
from portbench.reference import clustering
from portbench.reference import energy as ref_energy
from portbench.reference.eigen import Precision


def build(cfg: dict, X: torch.Tensor):
    builder = index.make_builder(cfg, X.device)
    aspace, gl = builder.build_energy(X.cpu().numpy())
    return aspace, gl, index.stage_seconds(builder)


def state(cfg: dict, aspace, gl) -> dict:
    if aspace.projection is not None:
        raise NotImplementedError("the reference holds the unprojected energy index only")
    return {"lambdas": aspace.lambdas.detach().clone(),
            "assignments": np.asarray(aspace.cluster_assignments).copy(),
            "sub_centroids": aspace.sub_centroids.detach().clone(),
            "laplacian": gl.dense().detach().clone(),
            "subcentroid_lambdas": np.asarray(aspace.subcentroid_lambdas, np.float64).copy()}


def reference(cfg: dict, X: torch.Tensor, prog: dict | None, prec: str = "f64"):
    b, p = cfg["builder"], Precision(prec)
    rep = clustering.replay(X, int(b["max_clusters"]), float(b["radius"]), p,
                            follow=None if prog is None else prog["assignments"])
    S, margins = ref_energy.sub_centroids(rep.centroids, cfg["graph"], cfg["energy"],
                                          X.shape[0], p,
                                          follow=None if prog is None else prog["sub_centroids"])
    ref = ref_energy.EnergyIndex(X, S, cfg["graph"], prec,
                                 follow=None if prog is None else prog["laplacian"])
    ref.clustering, ref.margins = rep, margins
    return ref


def reference_state(ref) -> dict:
    return {"lambdas": ref.lambdas.float(), "assignments": ref.clustering.assignments,
            "sub_centroids": ref.C.float(), "subcentroid_lambdas": ref.sc_lams.cpu().numpy()}


def answers(ref, traffic: dict, pool: np.ndarray) -> list:
    Qp, k, out = torch.from_numpy(pool).to(ref.X.device), int(traffic["k"]), []
    ref.prepare_queries(Qp, [])
    for q0 in range(0, len(pool), 256):
        v, i = torch.topk(-ref.distances(Qp[q0:q0 + 256], q0), k, dim=1)
        out.append((np.arange(q0, q0 + len(v)), i.cpu().numpy(), (-v).double().cpu().numpy()))
    return out


def _rel_err(got, want: torch.Tensor) -> float:
    """Largest |got − want| over want's largest entry (inf on another shape)."""
    got = torch.as_tensor(got).to(want.device).double()
    if tuple(got.shape) != tuple(want.shape):
        return float("inf")
    return float((got - want.double()).abs().max()) / max(float(want.abs().max()), 1e-30)


def judge(cfg: dict, traffic: dict, ref, prog: dict, pool: np.ndarray, win):
    """``(readings, extra)``: the window's answers (whole distances, and the
    cosine tie-break alone in its own units), every item's and sub-centroid's
    λ, the sub-centroids and the clustering's assignments, against the
    reference."""
    Qp = torch.from_numpy(pool).to(ref.X.device)
    n, k = ref.X.shape[0], int(traffic["k"])
    item_err = ref.resolve_items(prog["lambdas"])
    ref.prepare_queries(Qp, win.answers)
    readings = check.judge_answers(lambda a, b: ref.distances(Qp[a:b], a), n, win.answers, k,
                                   higher_is_better=False)
    scaled = [(q, i, np.asarray(d, np.float64) / ref_energy.TIE_EPS) for q, i, d in win.answers]
    # Groups whose λ lie within twice the λ limit of the query's may fall
    # together in the program's float32 λ: their items are not judged here.
    lam_tol = 2.0 * float(traffic["limits"]["item_lambda_err"])
    tie = check.judge_answers(lambda a, b: ref.group_cosine_distances(Qp[a:b], a, lam_tol), n,
                              scaled, k, higher_is_better=False,
                              score_below=ref_energy.OUT_OF_GROUP, skip_at=ref_energy.MERGED)
    readings["tie_dist_err"] = tie["score_err"]
    readings["tie_rank_gap"] = tie["rank_gap"]
    readings["item_lambda_err"] = item_err
    sc = np.asarray(prog["subcentroid_lambdas"], np.float64)
    want = ref.sc_lams.cpu().numpy()
    readings["subcentroid_lambda_err"] = (float(np.max(np.abs(sc - want)))
                                          if sc.shape == want.shape else float("inf"))
    readings["subcentroid_err"] = _rel_err(prog["sub_centroids"], ref.C)
    readings.update(clustering.readings(ref.clustering, prog["assignments"]))
    extra = {"ambiguous_rows": ref.clustering.ambiguous, "ambiguous_items": ref.ambiguous_items,
             "ambiguous_queries": ref.ambiguous_queries,
             "queries_in_groups_under_k": ref.small_group_queries(k),
             "sub_centroids": len(ref.C), "graph_ties": ref.graph_ties, **ref.margins}
    if win.units:
        # The tie band of each pool batch, averaged over the units sent.
        tb = int(traffic["batch"])
        band = {p: ref.tie_band(Qp[p * tb:(p + 1) * tb], p * tb) for p in set(win.units)}
        extra["tie_pairs"] = float(np.mean([band[p][0] for p in win.units]))
        extra["tie_rows"] = float(np.mean([band[p][1] for p in win.units]))
    return readings, extra
