"""refit.host_ms: host ms a call inside the program's `rtk.refit` spans
(scene.py's refit: the frame's gather in the sorted order, the leaf
bounds, the range table's levels and the node bounds), from the profiled
windows' host records; None where a window holds no `rtk.refit` span."""
from rtbench.spans import host_ms


def read(r):
    return host_ms(r, "rtk.refit", "rtk.refit")
