"""hits.host_ms: host ms a call inside the program's `rtk.hits.*` spans,
the lazy gathers of the record's fields (and the u/v recompute) that the
caller's field reads pay for, from the profiled windows' host records;
None where a window holds no span of the program."""
from rtbench.devtrace import busy_intervals

PREFIX = "rtk.hits."


def traced(w):
    """The window holds a span of the program."""
    return any(n.startswith("rtk.") for n, _, _ in w.host)


def read(r):
    if not r.windows or not all(map(traced, r.windows)):
        return None
    us = sum(e - s for w in r.windows for s, e in busy_intervals(
        [x for x in w.host if x[0].startswith(PREFIX)]))
    return us / 1e3 / r.calls
