"""Host records inside the program's spans in the profiled windows
(harness.Readings): the CUDA runtime's host syncs, and one span's records
inside another's.  A reader reads nothing (None) where a window holds no
span of its layer's prefix, as a program without those spans gives.

torch blocks the host on the card for a `nonzero`, a boolean-mask index,
`.item()`, `int()`, `tolist()` or a copy to the host by one
`cudaStreamSynchronize` after its copy (torch 2.11, CUDA 12.8 on the
H100: the records match the count of torch's own sync warnings), so a
host record of that runtime call is one host sync, and its length the
host's wait for the card.
"""
from __future__ import annotations

import bisect

from rtbench.devtrace import busy_intervals
from rtbench.spans import traced

SYNC_CALLS = ("cudaStreamSynchronize",)


def inside(w, names, prefix: str) -> list:
    """The host records of window w named in `names` that lie wholly
    inside a host record whose name starts with `prefix` (nested spans
    counted once)."""
    spans = busy_intervals([x for x in w.host if x[0].startswith(prefix)])
    starts = [s for s, _ in spans]
    out = []
    for rec in w.host:
        if rec[0] in names:
            i = bisect.bisect_right(starts, rec[1]) - 1
            if i >= 0 and rec[2] <= spans[i][1]:
                out.append(rec)
    return out


def syncs(r, prefix: str, layer: str):
    """Host syncs a call inside the spans starting with `prefix`; None
    unless every window holds a span starting with `layer`."""
    if not traced(r, layer):
        return None
    return sum(len(inside(w, SYNC_CALLS, prefix)) for w in r.windows) / r.calls


def sync_wait_ms(r, prefix: str, layer: str):
    """Host ms a call inside those syncs; None as `syncs`."""
    if not traced(r, layer):
        return None
    us = sum(e - s for w in r.windows
             for _, s, e in inside(w, SYNC_CALLS, prefix))
    return us / 1e3 / r.calls


def host_ms_inside(r, name: str, prefix: str, layer: str):
    """Host ms a call inside the records `name` that lie inside the spans
    starting with `prefix` (nested records counted once); None unless
    every window holds a span starting with `layer`."""
    if not traced(r, layer):
        return None
    us = sum(e - s for w in r.windows
             for s, e in busy_intervals(inside(w, (name,), prefix)))
    return us / 1e3 / r.calls
