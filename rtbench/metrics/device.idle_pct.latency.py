"""device.idle_pct.latency: share of the profiled windows, from each
window's first device record to its last, in which no operation ran on
the card, in %, in the cells whose end-to-end metric is a call's latency."""


def read(r):
    return r.idle_pct()
