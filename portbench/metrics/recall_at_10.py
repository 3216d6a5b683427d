"""``recall_at_10``: the share of the reference's top-10 that the window's
answers hold, over every query answered (an id at or above the
reference's 10th score counts)."""


def read(ctx):
    return ctx["readings"].get("recall")
