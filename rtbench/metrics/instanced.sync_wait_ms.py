"""instanced.sync_wait_ms: host ms a call inside the host syncs that
instanced.syncs counts (`cudaStreamSynchronize` records inside an
`rtk.instanced.*` span; rtbench/syncs.py): the host's wait for the card
in the instanced trace, apart from the host time spent launching work;
None where a window holds no `rtk.instanced.` span."""
from rtbench.syncs import sync_wait_ms


def read(r):
    return sync_wait_ms(r, "rtk.instanced.", "rtk.instanced.")
