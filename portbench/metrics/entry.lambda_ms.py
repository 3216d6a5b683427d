"""``entry.lambda_ms``: the median over the window's ``search.query_lambda``
spans (children of a ``search.batch``) of their host ms: the queries' λ, with the queries' projection (the
``search.project`` child, where the index has one) and any sync of the
route taken. The spans are the program's (``utils.profiling.spans``),
recorded only while the traced window's profiler runs (the window's own:
from its opening on); nothing to read where the program records none."""

import statistics


def read(ctx):
    try:
        from matternet_rs_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    opened = ctx["window"].setup_end * 1e9          # the window's spans only
    recs = [s for s in spans() if s.start_ns >= opened]
    roots = {s.id for s in recs if s.name == "search.batch"}
    ms = [(s.end_ns - s.start_ns) / 1e6
          for s in recs if s.name == "search.query_lambda" and s.parent in roots]
    return statistics.median(ms) if ms else None
