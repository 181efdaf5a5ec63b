"""path.compact_host_ms: host ms a call inside the render loop's
`rtk.path.compact` spans (each compacted bounce's live count, read on the
host, and the take of the live bucket: the sync's wait for the card shows
here), from the profiled windows' host records; None where a window holds
no `rtk.path.` span."""
from rtbench.spans import host_ms


def read(r):
    return host_ms(r, "rtk.path.compact", "rtk.path.")
