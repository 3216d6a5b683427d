"""``search_batch_sketch``: ``StreamingIndex.search_batch_sketch(Q, k,
alpha, candidates=...)``, refined: the resident sketch's scan, then the
exact rescore of the candidates read from the store."""


def make(aspace, gl, traffic):
    k, alpha, cand = int(traffic["k"]), float(traffic["alpha"]), traffic.get("candidates")
    return lambda Q: aspace.search_batch_sketch(Q, k, alpha, candidates=cand, refine=True)
