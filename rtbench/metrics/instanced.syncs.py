"""instanced.syncs: host syncs a call inside the instanced trace's spans:
host records of the CUDA runtime's `cudaStreamSynchronize`
(rtbench/syncs.py) that lie inside an `rtk.instanced.*` span, from the
profiled windows; the round's live counts and masks, the residual's and,
where it re-traces rays, its stack engine's steps.  None where a window
holds no `rtk.instanced.` span."""
from rtbench.syncs import syncs


def read(r):
    return syncs(r, "rtk.instanced.", "rtk.instanced.")
