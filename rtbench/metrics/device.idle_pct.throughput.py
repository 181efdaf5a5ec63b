"""device.idle_pct.throughput: share of the profiled windows, from each
window's first device record to its last, in which no operation ran on
the card, in %, in the cells whose end-to-end metric is a rate."""


def read(r):
    return r.idle_pct()
