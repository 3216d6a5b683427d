"""``entry.fetch_ms``: the median ``search.fetch`` span of a search call, in
ms: the device work still queued when the host asks for the answer, and
the answer's copy to the host. The spans are the program's
(``utils.profiling.spans``), recorded only while the traced window's
profiler runs (the window's own: from its opening on); nothing to
read where the program records none."""

import statistics


def read(ctx):
    try:
        from matternet_rs_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    opened = ctx["window"].setup_end * 1e9          # the window's spans only
    recs = [s for s in spans() if s.start_ns >= opened]
    roots = {s.id for s in recs if s.name == "search.batch"}
    fetch = [(s.end_ns - s.start_ns) / 1e6
             for s in recs if s.name == "search.fetch" and s.parent in roots]
    return statistics.median(fetch) if fetch else None
