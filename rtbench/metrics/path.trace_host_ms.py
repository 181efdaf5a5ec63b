"""path.trace_host_ms: host ms a call inside the render loop's
`rtk.path.trace` spans (each bounce's trace, around Tracer.closest: the
coherence key, the sort, the rows pass, the traversal kernel's launch and
the unsort), from the profiled windows' host records; None where a window
holds no `rtk.path.` span."""
from rtbench.spans import host_ms


def read(r):
    return host_ms(r, "rtk.path.trace", "rtk.path.")
