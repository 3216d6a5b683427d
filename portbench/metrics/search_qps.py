"""``search_qps``: queries answered in the window over the window's seconds
(a batch counts once its ids are on the host)."""

from portbench.harness.stats import rate


def read(ctx):
    return rate(ctx["window"].completed, ctx["window"].seconds)
