"""path.idle_pct: share of the profiled windows, from each window's first
device record to its last, in which no operation ran on the card while the
host was inside the render loop's `rtk.path.shade` or `rtk.path.compact`
spans, in %: the card's wait on the loop's own eager passes and per-bounce
sync; None where a window holds no `rtk.path.` span."""
from rtbench.spans import idle_pct

SPANS = ("rtk.path.shade", "rtk.path.compact")


def read(r):
    return idle_pct(r, SPANS, "rtk.path.")
