"""Device traces of the timed calls: padded profiler windows and their
reduction to busy time, kernel time and idle gaps.

The profiler loses the first device records of a window late in a process
(on the H100, 0-13 records in most windows, once 252).  So every window
opens and closes with PAD_SPINS short spins on the card
(torch.cuda._sleep), finished before the calls start and started after
they end, and a window counts only if a spin was recorded before the
calls' first record and one after their last (`clean`): its losses then
stayed in its spins.  The method is chip_smoke.py's `padded_profile` and
`clean_window`, copied here so that the yardstick does not move with the
program's tools.
"""
from __future__ import annotations

import dataclasses

import torch

PAD_SPINS = 256
SPIN_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel (ATen's Sleep.cu)
# The program's traversal kernel (csrc/packet_trace.cu), as its device
# records name it.
TRAVERSAL_KERNEL = "packet_trace_kernel"
# The benchmark's own spans (torch.profiler.record_function): the profiler
# also puts them on the device's timeline, where they are no device work.
SPAN_PREFIX = "rtbench."
WINDOWS = 3  # clean windows wanted
TRIES = 6  # windows tried at most
TOP = 10  # entries of each breakdown list
NAME_CHARS = 160


@dataclasses.dataclass
class Window:
    """One profiled window: device records (name, start_us, end_us) of the
    calls (spins left out), host records (name, start_us, end_us), the
    spins recorded before the calls' first record and after their last,
    and the calls it held."""

    device: list
    host: list
    lead: int
    tail: int
    calls: int

    @property
    def clean(self) -> bool:
        return self.lead > 0 and self.tail > 0


def split_spins(device_records, calls: int, host=()) -> Window:
    """A window from its raw device records (spins and the benchmark's
    spans included)."""
    device_records = [r for r in device_records
                      if not r[0].startswith(SPAN_PREFIX)]
    spins = [s for n, s, _ in device_records if SPIN_KERNEL in n]
    recs = [r for r in device_records if SPIN_KERNEL not in r[0]]
    lead = tail = 0
    if recs:
        first = min(s for _, s, _ in recs)
        last = max(e for _, _, e in recs)
        lead = sum(s < first for s in spins)
        tail = sum(s >= last for s in spins)
    return Window(device=recs, host=list(host), lead=lead, tail=tail,
                  calls=calls)


def record(run, calls: int) -> Window:
    """torch.profiler over `calls` calls of run(), in a padded window."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PAD_SPINS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        for _ in range(PAD_SPINS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
    dev, host = [], []
    for e in prof.events():
        r = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append(r)
        elif SPIN_KERNEL not in e.name and "_sleep" not in e.name:
            host.append(r)
    return split_spins(dev, calls, host)


def clean_windows(run, calls: int) -> list:
    """WINDOWS clean windows of `calls` calls each, trying up to TRIES;
    fails if none is clean."""
    kept = []
    for _ in range(TRIES):
        w = record(run, calls)
        if w.clean:
            kept.append(w)
            if len(kept) == WINDOWS:
                break
    if not kept:
        raise RuntimeError(f"the profiler's losses reached the calls in each "
                           f"of {TRIES} windows")
    return kept


def busy_intervals(recs):
    """The union of the records' intervals, sorted."""
    out = []
    for s, e in sorted((s, e) for _, s, e in recs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_window_us(w: Window):
    """(busy, window) microseconds of one window: the union of its device
    records, and the span from the first one's start to the last one's
    end."""
    iv = busy_intervals(w.device)
    if not iv:
        return 0.0, 0.0
    return sum(e - s for s, e in iv), iv[-1][1] - iv[0][0]


def device_ops(windows):
    """Device seconds by record name over the windows, largest first."""
    tot = {}
    for w in windows:
        for n, s, e in w.device:
            tot[n[:NAME_CHARS]] = tot.get(n[:NAME_CHARS], 0.0) + (e - s) / 1e6
    return sorted(tot.items(), key=lambda kv: (-kv[1], kv[0]))


def idle_gaps(windows):
    """Idle device seconds by what the host was doing: each gap between
    busy intervals is named by the shortest host record covering its
    start ("host: no record" where none does), largest total first."""
    tot = {}
    for w in windows:
        iv = busy_intervals(w.device)
        host = sorted(w.host, key=lambda r: r[1])
        i, active = 0, []
        for (_, a), (b, _) in zip(iv, iv[1:]):
            while i < len(host) and host[i][1] <= a:
                active.append(host[i])
                i += 1
            active = [r for r in active if r[2] > a]
            name = (min(active, key=lambda r: r[2] - r[1])[0][:NAME_CHARS]
                    if active else "host: no record")
            tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
    return sorted(tot.items(), key=lambda kv: (-kv[1], kv[0]))
