"""instanced.round_trace_host_ms: host ms a call inside the rooted traces
of the candidate rounds: the `rtk.packet_trace` records that lie inside
an `rtk.instanced.round` span (the front end and the roots variant's
launch), from the profiled windows' host records; None where a window
holds no `rtk.instanced.` span."""
from rtbench.syncs import host_ms_inside


def read(r):
    return host_ms_inside(r, "rtk.packet_trace", "rtk.instanced.round",
                          "rtk.instanced.")
