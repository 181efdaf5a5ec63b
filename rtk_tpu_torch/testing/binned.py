"""Binned (re-binned) tracing (rtk_tpu.testing.binned): rays re-grouped
over a shallow cut of the BVH between traversal passes.

  1. Cut the packed 8-wide tree at a shallow depth into subtree "bins",
     each an entry in the kernel's stack encoding (a node row, or a leaf
     that surfaces above the cut) with the box its parent row holds (host
     NumPy, cached per table).
  2. Dense candidate pass: every ray against every bin's box keeps the C
     nearest entry distances (instancing's candidate pass, shared).
  3. C rounds: the rays whose round-s bin still enters before their best
     hit, grouped by bin, trace the kernel's roots variant from their
     bin's entry with their best hit as the window's end.
  4. Exactness: a ray whose (C+1)-th bin still enters before its best hit
     re-traces the full tree (the residual).

Every round launches over the whole batch (rays not live for it carry an
empty window), so the rounds make no host sync.  The TPU's padding of
each bin's rays to whole packets has no counterpart: every thread carries
its own root.  Same hit-record contract as trace_packets: nearest hit,
open (min_t, max_t) window, strict < tie (rtk.c:543-577).
"""
from __future__ import annotations

import numpy as np
import torch

from rtk_tpu_torch.instancing import _instance_candidates_impl
from rtk_tpu_torch.ops.packet_trace import (_trace_rooted,
                                            check_root_entries, front_steps,
                                            trace_packets)
from rtk_tpu_torch.trace.packed import PackedScene
from rtk_tpu_torch.types import PacketHits, Rays


def subtree_bins(packed: PackedScene, depth: int = 2, root: int = 0):
    """Cut the packed 8-wide tree at `depth` -> (roots (R,) int32 entries,
    lo (R, 3) f32, hi (R, 3) f32), host NumPy, bit-equal to rtk_tpu's.

    Entries use the kernel's stack encoding: >= 0 a node row, <= -2 a leaf
    (shallow trees surface leaves above the cut; such a root starts the
    traversal at the leaf).  Bounds come from the parent's child rows, so
    each bin's box is exact.
    """
    if packed.branching != 8:
        raise ValueError("subtree_bins cuts 8-wide tables")
    nodes = packed.nodes.cpu().numpy().reshape(-1, 8, 8)  # (Nd, W, 8)
    bounds = nodes[:, :, :6].view(np.float32)

    entries = [(np.int64(root), None, None)]  # (entry, lo, hi)
    for _ in range(depth):
        nxt = []
        for ent, lo, hi in entries:
            if ent < 0:  # leaf already; keep as its own bin
                nxt.append((ent, lo, hi))
                continue
            row = nodes[ent]
            fc, fl = row[0, 6], row[0, 7]
            masks = row[1, 6]
            im, lm = masks & 0xFF, (masks >> 8) & 0xFF
            irank = lrank = 0
            for w in range(8):
                clo = bounds[ent, w, 0:3]
                chi = bounds[ent, w, 3:6]
                if (im >> w) & 1:
                    nxt.append((np.int64(fc + irank), clo, chi))
                    irank += 1
                elif (lm >> w) & 1:
                    nxt.append((np.int64(-(fl + lrank) - 2), clo, chi))
                    lrank += 1
        entries = nxt

    roots = np.array([e for e, _, _ in entries], np.int32)
    # The root itself has no parent row; only possible when depth == 0.
    lo = np.stack([l if l is not None else np.full(3, -np.inf, np.float32)
                   for _, l, _ in entries])
    hi = np.stack([h if h is not None else np.full(3, np.inf, np.float32)
                   for _, _, h in entries])
    return roots, lo.astype(np.float32), hi.astype(np.float32)


class _BinsCache:
    """Per-PackedScene bin tables (host precompute, keyed by the id of the
    node table).  Each entry holds a strong reference to the keyed table:
    an id alone is unsafe, since a freed table's id can be reused by a new
    one, which would be served stale bins.  A bounded FIFO keeps the held
    tables from accumulating."""

    MAX_ENTRIES = 16

    def __init__(self):
        self._cache = {}

    def get(self, packed: PackedScene, depth: int):
        """-> (roots (R,) int32, lo (R, 3), hi (R, 3), R) on the table's
        device; the roots are checked against the tables here, once, so
        the rounds launch from them with no host sync."""
        key = (id(packed.nodes), depth)
        hit = self._cache.get(key)
        if hit is not None and hit[0] is packed.nodes:
            return hit[1]
        roots, lo, hi = subtree_bins(packed, depth)
        check_root_entries(roots, packed.nodes.shape[0] // packed.branching,
                           packed.tris.shape[0] // packed.leaf_size)
        dev = packed.device
        val = (torch.as_tensor(roots, device=dev),
               torch.as_tensor(lo, device=dev),
               torch.as_tensor(hi, device=dev), roots.shape[0])
        if len(self._cache) >= self.MAX_ENTRIES:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = (packed.nodes, val)
        return val


_BINS = _BinsCache()


def trace_packets_binned(packed: PackedScene, rays: Rays,
                         mode: str = "closest", watertight: bool = True,
                         interpret: bool = False, depth: int = 2,
                         max_candidates: int = 8, unit: int = 128,
                         filter_mask: int | None = None) -> PacketHits:
    """Trace a ray batch by re-binning over subtree bins -> PacketHits.

    Same hit-record contract as trace_packets; exact: a residual pass over
    the full tree covers rays whose candidate list overflowed.  unit is
    the packet width the reference passes its launches (pkt, checked as
    there); interpret picks the TPU program's mode and has no effect.
    """
    if mode not in ("closest", "any"):
        raise ValueError(f"unknown mode {mode!r}")
    if rays.device != packed.device:
        raise ValueError(f"rays on {rays.device}, scene on {packed.device}")
    n = rays.count
    dev = rays.device
    steps = front_steps(dev)
    bin_roots, bin_lo, bin_hi, n_bins = _BINS.get(packed, depth)
    c = min(max_candidates, n_bins)
    cand_idx, cand_t, overflow = _instance_candidates_impl(bin_lo, bin_hi,
                                                           rays, c)
    best_t = rays.max_t.clone()
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    best_s = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for s in range(c):
        # Live: the round's bin enters before the best hit (no bin: inf).
        live = cand_t[:, s] < best_t
        key = torch.where(live, cand_idx[:, s], n_bins)
        order = torch.sort(key, stable=True).indices
        bt = best_t[order]
        h = _trace_rooted(
            steps, packed,
            Rays(rays.origin[order], rays.direction[order],
                 rays.min_t[order], torch.where(live[order], bt, 0.0)),
            bin_roots[key[order].clamp_max(n_bins - 1)], mode=mode,
            watertight=watertight, filter_mask=filter_mask, pkt=unit)
        improved = (h.slot >= 0) & (h.t < bt)
        best_t[order] = torch.where(improved, h.t, bt)
        best_u[order] = torch.where(improved, h.u, best_u[order])
        best_v[order] = torch.where(improved, h.v, best_v[order])
        best_s[order] = torch.where(improved, h.slot, best_s[order])
    # Exactness residual: rays whose (C+1)-th bin entry could still beat
    # the best hit re-trace the full tree.
    resid = overflow < best_t
    hr = trace_packets(packed, Rays(rays.origin, rays.direction, rays.min_t,
                                    torch.where(resid, best_t, 0.0)),
                       mode=mode, watertight=watertight, pkt=unit,
                       sort_rays=False, filter_mask=filter_mask)
    improved = hr.hit & (hr.t < best_t)
    best_t = torch.where(improved, hr.t, best_t)
    best_u = torch.where(improved, hr.u, best_u)
    best_v = torch.where(improved, hr.v, best_v)
    best_s = torch.where(improved, hr.slot, best_s)
    return PacketHits(
        hit=best_s >= 0, t=best_t, u_k=best_u, v_k=best_v, slot=best_s,
        origin=rays.origin, direction=rays.direction, tri_v=packed.tri_v,
        tri_vidx=packed.tri_vidx, tri_mesh=packed.tri_mesh,
        tri_prim=packed.tri_prim)
