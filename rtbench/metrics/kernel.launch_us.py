"""kernel.launch_us: host us a call inside the program's
`rtk.packet_trace.launch` spans, the traversal kernel's launch (its
checks, the library's lookup, the outputs' allocation and the ctypes
call), from the profiled windows' host records; None where a window
holds no span of the program."""
from rtbench.devtrace import busy_intervals

SPAN = "rtk.packet_trace.launch"


def traced(w):
    """The window holds a span of the program."""
    return any(n.startswith("rtk.") for n, _, _ in w.host)


def read(r):
    if not r.windows or not all(map(traced, r.windows)):
        return None
    us = sum(e - s for w in r.windows
             for s, e in busy_intervals([x for x in w.host if x[0] == SPAN]))
    return us / r.calls
