"""refit.idle_pct: share of the profiled windows, from each window's first
device record to its last, in which no operation ran on the card while the
host was inside the program's `rtk.refit` or `rtk.repack` spans, in %: the
card's wait on the frame's eager refit and repack; None where a window
holds no `rtk.refit` span."""
from rtbench.spans import idle_pct

SPANS = ("rtk.refit", "rtk.repack")


def read(r):
    return idle_pct(r, SPANS, "rtk.refit")
