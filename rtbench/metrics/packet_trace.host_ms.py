"""packet_trace.host_ms: host ms a call inside the program's
`rtk.packet_trace` spans (the packet front end: its checks, the rows,
the coherence key, sort and gather, the traversal's launch, the unsort
and the PacketHits), its steps included, from the profiled windows' host
records; None where a window holds no span of the program."""
from rtbench.devtrace import busy_intervals

SPAN = "rtk.packet_trace"


def traced(w):
    """The window holds a span of the program."""
    return any(n.startswith("rtk.") for n, _, _ in w.host)


def read(r):
    if not r.windows or not all(map(traced, r.windows)):
        return None
    us = sum(e - s for w in r.windows
             for s, e in busy_intervals([x for x in w.host if x[0] == SPAN]))
    return us / 1e3 / r.calls
