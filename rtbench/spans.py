"""The program's spans in the profiled windows (harness.Readings): host
time a call inside a span, and the card's idle share while the host is
inside some spans.  A reader reads nothing (None) where a window holds no
span of its layer's prefix, as a program without those spans gives."""
from __future__ import annotations

from pathlib import Path

from rtbench.devtrace import busy_intervals
from rtbench.loader import load_module

# The intersection of two interval lists, as the program's idle reader
# computes it.
overlap_us = load_module(Path(__file__).parent / "metrics" /
                         "device.idle_pct.program.py").overlap_us


def traced(r, prefix: str) -> bool:
    """Every window holds a span whose name starts with prefix."""
    return bool(r.windows) and all(
        any(n.startswith(prefix) for n, _, _ in w.host) for w in r.windows)


def host_ms(r, name: str, prefix: str):
    """Host ms a call inside the spans `name` (nested ones counted once);
    None unless traced(r, prefix)."""
    if not traced(r, prefix):
        return None
    us = sum(e - s for w in r.windows
             for s, e in busy_intervals([x for x in w.host if x[0] == name]))
    return us / 1e3 / r.calls


def idle_pct(r, names, prefix: str):
    """Share of the windows, from each one's first device record to its
    last, in which no operation ran on the card while the host was inside
    one of the spans `names`, in %; None unless traced(r, prefix)."""
    if not traced(r, prefix):
        return None
    inside = span = 0.0
    for w in r.windows:
        busy = busy_intervals(w.device)
        if not busy:
            continue
        span += busy[-1][1] - busy[0][0]
        idle = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])]
        host = busy_intervals([x for x in w.host if x[0] in names])
        inside += overlap_us(idle, host)
    return 100.0 * inside / span if span > 0 else None
