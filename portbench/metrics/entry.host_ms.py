"""``entry.host_ms``: the median over the window's ``search.batch`` spans of
the span less its ``search.fetch`` child, in ms: the host's time in a
search call while it is not waiting for the answer. The spans are the
program's (``utils.profiling.spans``), recorded only while the traced
window's profiler runs (the window's own: from its opening on); nothing to
read where the program records none."""

import statistics


def read(ctx):
    try:
        from matternet_rs_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    opened = ctx["window"].setup_end * 1e9          # the window's spans only
    recs = [s for s in spans() if s.start_ns >= opened]
    fetch = {s.parent: s.end_ns - s.start_ns for s in recs if s.name == "search.fetch"}
    host = [(s.end_ns - s.start_ns - fetch[s.id]) / 1e6
            for s in recs if s.name == "search.batch" and s.id in fetch]
    return statistics.median(host) if host else None
