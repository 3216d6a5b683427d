"""``refine.read_ms``: the median ``refine.read`` span of a refined sketch
search, in ms: the candidate union's ids made unique, its rows read from
the store and its λ gathered, all on the host. The spans are the
program's (``utils.profiling.spans``), recorded only while the traced
window's profiler runs (the window's own: from its opening on); nothing
to read where the program records none."""

import statistics


def read(ctx):
    try:
        from matternet_rs_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    opened = ctx["window"].setup_end * 1e9          # the window's spans only
    reads = [(s.end_ns - s.start_ns) / 1e6
             for s in spans() if s.start_ns >= opened and s.name == "refine.read"]
    return statistics.median(reads) if reads else None
