"""instanced.rounds_host_ms: host ms a call inside the instanced trace's
`rtk.instanced.round` spans (each candidate round: its live count's host
sync, the sort by instance, the object rays, the rooted trace through the
traversal kernel and the scatter of the better hits), from the profiled
windows' host records; None where a window holds no `rtk.instanced.`
span."""
from rtbench.spans import host_ms


def read(r):
    return host_ms(r, "rtk.instanced.round", "rtk.instanced.")
