"""instanced.candidates_host_ms: host ms a call inside the instanced
trace's `rtk.instanced.candidates` spans (each trace's dense rays x
instances slab that keeps every ray's nearest candidates, and the
exactness residual's slab over all instances), from the profiled windows'
host records; None where a window holds no `rtk.instanced.` span."""
from rtbench.spans import host_ms


def read(r):
    return host_ms(r, "rtk.instanced.candidates", "rtk.instanced.")
