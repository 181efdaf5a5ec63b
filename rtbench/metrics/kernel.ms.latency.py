"""kernel.ms.latency: device ms a call in the traversal kernel
(csrc/packet_trace.cu), from the profiled windows' kernel records, in the
cells whose end-to-end metric is a call's latency."""
from rtbench.devtrace import TRAVERSAL_KERNEL


def read(r):
    return r.kernel_ms(TRAVERSAL_KERNEL)
