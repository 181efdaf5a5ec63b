"""path.sync_wait_ms: host ms a call inside the host syncs of the render
loop's `rtk.path.compact` spans (`cudaStreamSynchronize` records inside
them, rtbench/syncs.py: each compacted bounce's live count read on the
host): the wait for the card in path.compact_host_ms, apart from the
take; None where a window holds no `rtk.path.` span."""
from rtbench.syncs import sync_wait_ms


def read(r):
    return sync_wait_ms(r, "rtk.path.compact", "rtk.path.")
