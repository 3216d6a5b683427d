"""``search_batch``: ``ArrowSpace.search_batch(Q, gl, k, alpha,
quantized=...)``, the tier by the mix's ``quantized``."""


def make(aspace, gl, traffic):
    k, alpha = int(traffic["k"]), float(traffic["alpha"])
    qz = traffic.get("quantized", False)
    return lambda Q: aspace.search_batch(Q, gl, k, alpha, quantized=qz)
