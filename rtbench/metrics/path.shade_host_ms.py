"""path.shade_host_ms: host ms a call inside the render loop's
`rtk.path.shade` spans (each bounce's shade, sample and sort pass: the
lazy record's gathers, the cosine directions, the live flags and the
coherence order), from the profiled windows' host records; None where a
window holds no `rtk.path.` span."""
from rtbench.spans import host_ms


def read(r):
    return host_ms(r, "rtk.path.shade", "rtk.path.")
