"""refit.repack_host_ms: host ms a call inside the program's `rtk.repack`
spans (trace/packed.py's repack_bounds, through Tracer.refresh: the node
rows and the triangle table gathered again), from the profiled windows'
host records; None where a window holds no `rtk.repack` span."""
from rtbench.spans import host_ms


def read(r):
    return host_ms(r, "rtk.repack", "rtk.repack")
