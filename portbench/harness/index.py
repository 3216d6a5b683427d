"""The port's builder, set as a configuration file states it."""

from __future__ import annotations


def make_builder(cfg: dict, device):
    from matternet_rs_tpu_torch import ArrowSpaceBuilder

    b = cfg["builder"]
    n = int(cfg["shape"]["n_items"])
    out = (ArrowSpaceBuilder(device=device)
           .with_lambda_graph(*b["lambda_graph"])
           .with_sparsity_check(bool(b["sparsity_check"]))
           .with_cluster_params(max_clusters=int(b["max_clusters"]), radius=float(b["radius"]))
           .with_sampling(None if b["sampling"] is None else tuple(b["sampling"])))
    if b.get("expected_items"):
        out = out.with_expected_items(n)
    if b.get("dims_reduction"):
        out = out.with_dims_reduction(True)
    return out


def stage_seconds(builder) -> dict:
    return dict(getattr(builder, "last_stage_timings", {}))
