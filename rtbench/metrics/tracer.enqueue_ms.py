"""tracer.enqueue_ms: host ms from a call's entry (Tracer.closest) to the
return of its last record field, before the synchronize; the mean over
the window's calls (host clock)."""


def read(r):
    return sum(r.enqueue_ms) / len(r.enqueue_ms) if r.enqueue_ms else None
