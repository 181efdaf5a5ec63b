"""packet_trace_roofline: the traversal kernel's share of its roofline, in
%: the least time the card could take for the call's work (the larger of
the benchmark's own count of f32 operations over the card's f32
instruction rate and of bytes over its memory rate, rtbench/workcount.py)
over the kernel's measured device ms a call."""
from rtbench.devtrace import TRAVERSAL_KERNEL


def read(r):
    ms = r.kernel_ms(TRAVERSAL_KERNEL)
    if not ms or r.bound is None:
        return None
    return 100.0 * r.bound["ms"] / ms
