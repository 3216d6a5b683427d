"""``refine.union_rows``: the median over the window's ``search.refine``
spans of their ``rows`` attribute: the distinct candidate rows a batch
reads from the store and rescores. The spans are the program's
(``utils.profiling.spans``), recorded only while the traced window's
profiler runs (the window's own: from its opening on); nothing to read
where the program records none."""

import statistics


def read(ctx):
    try:
        from matternet_rs_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    opened = ctx["window"].setup_end * 1e9          # the window's spans only
    rows = [s.attrs["rows"] for s in spans()
            if s.start_ns >= opened and s.name == "search.refine" and "rows" in s.attrs]
    return float(statistics.median(rows)) if rows else None
