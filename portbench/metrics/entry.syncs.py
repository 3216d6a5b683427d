"""``entry.syncs``: the median over the window's ``search.batch`` spans of
the host–device syncs counted in the span and the spans inside it (a
blocking copy, a device value read on the host), per call. The spans are
the program's (``utils.profiling.spans``), recorded only while the traced
window's profiler runs (the window's own: from its opening on); nothing to
read where the program records none."""

import collections
import statistics


def read(ctx):
    try:
        from matternet_rs_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    opened = ctx["window"].setup_end * 1e9          # the window's spans only
    recs = [s for s in spans() if s.start_ns >= opened]
    syncs = collections.Counter()
    for s in recs:
        syncs[s.root] += s.syncs
    per_call = [syncs[s.id] for s in recs if s.name == "search.batch"]
    return statistics.median_low(per_call) if per_call else None
