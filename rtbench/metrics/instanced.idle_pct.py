"""instanced.idle_pct: share of the profiled windows, from each window's
first device record to its last, in which no operation ran on the card
while the host was inside an instanced trace's spans (`rtk.instanced.*`:
the slab, the rounds and their syncs, the residual), in %: the card's wait
on the instanced trace's eager passes and host syncs; None where a window
holds no `rtk.instanced.` span."""
from rtbench.spans import idle_pct

SPANS = ("rtk.instanced.trace", "rtk.instanced.candidates",
         "rtk.instanced.round", "rtk.instanced.residual")


def read(r):
    return idle_pct(r, SPANS, "rtk.instanced.")
