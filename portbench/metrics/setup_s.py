"""``setup_s``: seconds from the process's start to the window's opening:
imports, the CUDA context, the corpus on the card, the build and the
warm-up of the cell's shapes."""


def read(ctx):
    return ctx["setup_s"]
