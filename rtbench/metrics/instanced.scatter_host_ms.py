"""instanced.scatter_host_ms: host ms a call inside the candidate rounds'
`rtk.instanced.scatter` spans (a launched round's better-hit mask, its six
boolean-mask indexes, each a host sync, and the index-puts), from the
profiled windows' host records; None where a window holds no
`rtk.instanced.scatter` span."""
from rtbench.spans import host_ms


def read(r):
    return host_ms(r, "rtk.instanced.scatter", "rtk.instanced.scatter")
