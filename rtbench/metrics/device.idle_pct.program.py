"""device.idle_pct.program: share of the profiled windows, from each
window's first device record to its last, in which no operation ran on
the card while the host was inside a span of the program (`rtk.*`), in %:
the part of device.idle_pct.latency that the program's own host work
leaves; the rest is the caller's and the synchronize's.  None where a
window holds no span of the program."""
from rtbench.devtrace import busy_intervals


def overlap_us(a, b):
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        tot += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def traced(w):
    """The window holds a span of the program."""
    return any(n.startswith("rtk.") for n, _, _ in w.host)


def read(r):
    if not r.windows or not all(map(traced, r.windows)):
        return None
    inside = span = 0.0
    for w in r.windows:
        busy = busy_intervals(w.device)
        if not busy:
            continue
        span += busy[-1][1] - busy[0][0]
        idle = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])]
        program = busy_intervals([x for x in w.host
                                  if x[0].startswith("rtk.")])
        inside += overlap_us(idle, program)
    return 100.0 * inside / span if span > 0 else None
