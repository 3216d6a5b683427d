"""``search_energy_batch``: ``energymaps.search_energy_batch(aspace, Q, gl,
k, candidates=...)``, the full scan where ``candidates`` is null."""


def make(aspace, gl, traffic):
    from matternet_rs_tpu_torch import energymaps

    k, cand = int(traffic["k"]), traffic.get("candidates")
    return lambda Q: energymaps.search_energy_batch(aspace, Q, gl, k, candidates=cand)
