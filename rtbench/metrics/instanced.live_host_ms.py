"""instanced.live_host_ms: host ms a call inside the candidate rounds'
`rtk.instanced.live` spans (each round's live mask and its `nonzero` host
sync: the wait for the card's queue shows here), from the profiled
windows' host records; None where a window holds no `rtk.instanced.live`
span."""
from rtbench.spans import host_ms


def read(r):
    return host_ms(r, "rtk.instanced.live", "rtk.instanced.live")
