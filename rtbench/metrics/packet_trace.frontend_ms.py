"""packet_trace.frontend_ms: device ms a call outside the traversal
kernel (the coherence key, the sort, the gather and stacking of the rows,
the unsort and the record gathers), from the profiled windows' records."""
from rtbench.devtrace import TRAVERSAL_KERNEL


def read(r):
    return r.kernel_ms(TRAVERSAL_KERNEL, inside=False)
