"""instanced.rays_host_ms: host ms a call inside the candidate rounds'
`rtk.instanced.rays` spans (a launched round's gather of its candidates,
the sort by instance, the round cap, the object rays and the gathers of
best t and roots, up to the rooted trace), from the profiled windows'
host records; None where a window holds no `rtk.instanced.rays` span."""
from rtbench.spans import host_ms


def read(r):
    return host_ms(r, "rtk.instanced.rays", "rtk.instanced.rays")
