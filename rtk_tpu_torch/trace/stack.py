"""Batched ordered BVH traversal over the Scene's wide nodes (plain PyTorch).

rtk_tpu.trace.stack's engine: a whole ray batch steps in lockstep, every
ray carrying its own short stack in an (N, max_stack) tensor.  Each step,
per ray:

  1. pop: rays whose current node is consumed (-1) or culled (entry t >=
     closest hit t, the pop-cull of rtk.c:432-437) pop their stack; rays
     with empty stacks finish;
  2. leaf: rays at a leaf intersect its K contiguous triangles with the
     watertight test (rtk.c:181-388);
  3. internal: rays at a wide node slab-test all W children, sort the hits
     near-to-far with a compare-exchange network (rtk.c:489-536), descend
     to the nearest and push the rest with their entry t.

A filter callable (rtk_filter_fn, rtk.h:117) sees each leaf's (N, K)
candidates as a HitCandidate and returns a bool mask; it is plain Python
on real tensors, so any torch code works here (the kernel's filter
variant takes only predicates that jit_filter can capture).

Unlike the reference, a push that would overflow max_stack raises instead
of being dropped.  trace_closest / trace_any, Tracer(engine="stack"),
compat's single-ray calls, the instanced path's exactness residual and
trace_closest_instanced run on it.
"""
from __future__ import annotations

import numpy as np
import torch

from rtk_tpu_torch.config import TraceConfig
from rtk_tpu_torch.ops.intersect import (intersect_triangles, ray_shear,
                                         rcp_direction, slab_test)
from rtk_tpu_torch.types import HitCandidate, Hits, Rays

INF = float("inf")

# Batcher odd-even merge sorting networks (ascending).
_NETWORKS = {
    2: [(0, 1)],
    4: [(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)],
    8: [
        (0, 1), (2, 3), (4, 5), (6, 7),
        (0, 2), (1, 3), (4, 6), (5, 7),
        (1, 2), (5, 6),
        (0, 4), (1, 5), (2, 6), (3, 7),
        (2, 4), (3, 5),
        (1, 2), (3, 4), (5, 6),
    ],
}


def _sort_w(ts, children, w):
    """Sort W (t, child) pairs per ray ascending by t (vector comparators)."""
    t_cols = [ts[:, i] for i in range(w)]
    c_cols = [children[:, i] for i in range(w)]
    for a, b in _NETWORKS[w]:
        swap = t_cols[a] > t_cols[b]
        t_cols[a], t_cols[b] = (torch.where(swap, t_cols[b], t_cols[a]),
                                torch.where(swap, t_cols[a], t_cols[b]))
        c_cols[a], c_cols[b] = (torch.where(swap, c_cols[b], c_cols[a]),
                                torch.where(swap, c_cols[a], c_cols[b]))
    return t_cols, c_cols


__all__ = ["HitCandidate", "trace_closest", "trace_any", "wide_depth"]


def _trace_loop(scene, rays: Rays, *, mode: str, config: TraceConfig,
                filter_fn=None, start_node=None, init_hit_t=None,
                return_slot=False, ray_offset: int = 0):
    """Trace `rays` through `scene` from `start_node` (per ray; default:
    wide node 0) -> Hits, or (Hits, sorted-scene slot) with return_slot.

    mode: "closest" or "any" (a ray stops at its first accepted hit).
    filter_fn: None or HitCandidate -> bool mask, ANDed into each leaf's
      accept test (ray_index: ray_offset + the row of `rays`, so a shard
      of a batch, parallel/shard.py, sees the caller's index).
    init_hit_t: per-ray starting closest t (default: rays.max_t).
    """
    if not scene.has_wide:
        raise ValueError(
            "scene was built with BuildConfig(wide_nodes=False); the stack "
            "engine needs the wide node arrays")
    if mode not in ("closest", "any"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = rays.device
    n = rays.count
    w = scene.branching
    d = config.max_stack
    k = scene.leaf_size
    tp = scene.num_padded_tris
    n_nodes = scene.node_child.shape[0]

    origin = rays.origin
    min_t = rays.min_t
    shear = ray_shear(rays.direction)
    rcp = rcp_direction(rays.direction)
    rows = torch.arange(n, device=dev)
    rows32 = rows.to(torch.int32) + ray_offset
    lane = torch.arange(k, device=dev)

    cur = (torch.zeros((n,), dtype=torch.int64, device=dev)
           if start_node is None
           else torch.as_tensor(start_node, device=dev).to(torch.int64))
    cur_t = torch.full((n,), -INF, device=dev)  # rtk.c:399
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    # Column d is a sink for masked-off pushes (no sync to select rows).
    stack_node = torch.zeros((n, d + 1), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((n, d + 1), device=dev)
    hit_t = (rays.max_t if init_hit_t is None else init_hit_t).clone()
    hit_u = torch.zeros((n,), device=dev)
    hit_v = torch.zeros((n,), device=dev)
    hit_slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    finished = torch.zeros((n,), dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    steps = 0

    def check_stack():
        if bool(overflow):
            raise RuntimeError(
                f"a ray's traversal stack needs more than max_stack={d} "
                "entries; trace with a larger TraceConfig.max_stack")

    while not (config.max_steps and steps >= config.max_steps):
        # ---- pop phase (rtk.c:432-437 including pop-culling) ----
        need = (cur == -1) | (cur_t >= hit_t)
        can = sp > 0
        do_pop = need & can
        finished = finished | (need & ~can)
        # One host sync a step: the loop test and the stack check.
        done, over = torch.stack([finished.all(), overflow]).tolist()
        if over or done:
            break
        spm1 = (sp - 1).clamp(min=0)
        popped_n = stack_node[rows, spm1]
        popped_t = stack_t[rows, spm1]
        cur = torch.where(do_pop, popped_n, torch.where(need, -1, cur))
        cur_t = torch.where(do_pop, popped_t,
                            torch.where(need, INF, cur_t))
        sp = torch.where(do_pop, spm1, sp)

        active = (cur_t < hit_t) & ~finished
        is_leaf = active & (cur <= -2)
        is_int = active & (cur >= 0)

        # ---- leaf phase (rtk.c:181-388) ----
        start = torch.where(is_leaf, (-cur - 2) * k, 0)
        count = (scene.num_tris - start).clamp(0, k)
        tidx = (start[:, None] + lane[None, :]).clamp(0, tp - 1)
        t, u, v, valid = intersect_triangles(
            origin, shear, scene.tri_v[tidx], min_t, hit_t,
            watertight=config.watertight)
        valid = valid & (lane[None, :] < count[:, None]) & is_leaf[:, None]
        if filter_fn is not None:
            valid = valid & filter_fn(HitCandidate(
                t=t, u=u, v=v, mesh_index=scene.tri_mesh[tidx],
                triangle_index=scene.tri_prim[tidx],
                ray_index=rows32[:, None].expand(n, k)))
        # Nearest valid lane, the first on ties (rtk.c:366-385).
        tb, kb = torch.where(valid, t, INF).min(dim=1)
        improved = tb < hit_t  # strict (rtk.c:371)
        pick = lambda a: a.gather(1, kb[:, None])[:, 0]
        hit_t = torch.where(improved, tb, hit_t)
        hit_u = torch.where(improved, pick(u), hit_u)
        hit_v = torch.where(improved, pick(v), hit_v)
        hit_slot = torch.where(improved, pick(tidx), hit_slot)
        cur = torch.where(is_leaf, -1, cur)  # consume the leaf (rtk.c:443)
        if mode == "any":
            finished = finished | improved
            sp = torch.where(improved, 0, sp)
            cur = torch.where(improved, -1, cur)

        # ---- internal phase (rtk.c:449-536) ----
        nid = cur.clamp(0, n_nodes - 1)
        ts, hitm = slab_test(scene.node_min[nid], scene.node_max[nid],
                             origin, rcp, min_t, hit_t)
        kcount = hitm.sum(dim=1)
        t_cols, c_cols = _sort_w(ts, scene.node_child[nid].to(torch.int64),
                                 w)
        pushed = torch.where(is_int, (kcount - 1).clamp(min=0), 0)
        # Where the reference drops pushes past max_stack, refuse (checked
        # at the next step's sync; overflowing writes go to the sink).
        overflow = overflow | (sp + pushed > d).any()
        has = is_int & (kcount > 0)
        # Push children 1..kcount-1 far-to-near so the nearest pops first.
        for i in range(1, w):
            col = torch.where(is_int & (i < kcount),
                              (sp + (kcount - 1 - i)).clamp(max=d), d)
            stack_node[rows, col] = c_cols[i]
            stack_t[rows, col] = t_cols[i]
        sp = sp + pushed
        cur = torch.where(is_int, torch.where(has, c_cols[0], -1), cur)
        cur_t = torch.where(is_int, torch.where(has, t_cols[0], INF), cur_t)
        steps += 1
    check_stack()

    hit = hit_slot >= 0
    safe = hit_slot.clamp(0, tp - 1)
    zero = torch.zeros((), device=dev)
    hits = Hits(
        hit=hit,
        t=hit_t,  # == ray.max_t when no hit (only ever decreases)
        u=torch.where(hit, hit_u, zero),
        v=torch.where(hit, hit_v, zero),
        mesh_index=torch.where(hit, scene.tri_mesh[safe], -1),
        triangle_index=torch.where(hit, scene.tri_prim[safe], -1),
        vertex_position=torch.where(hit[:, None, None], scene.tri_v[safe],
                                    zero),
        vertex_index=torch.where(hit[:, None], scene.tri_vidx[safe], -1),
    )
    if return_slot:
        return hits, hit_slot.to(torch.int32)
    return hits


def _trace(scene, rays: Rays, mode, filter_fn, config) -> Hits:
    if rays.device != scene.device:
        raise ValueError(f"rays on {rays.device}, scene on {scene.device}")
    return _trace_loop(scene, rays, mode=mode, config=config,
                       filter_fn=filter_fn)


def trace_closest(scene, rays: Rays, filter_fn=None,
                  config: TraceConfig = TraceConfig()) -> Hits:
    """Nearest-hit trace (rtk_trace_ray, rtk.c:543-577) in plain
    PyTorch on the scene's device; filter_fn: HitCandidate -> bool."""
    return _trace(scene, rays, "closest", filter_fn, config)


def trace_any(scene, rays: Rays, filter_fn=None,
              config: TraceConfig = TraceConfig()) -> Hits:
    """Any-hit trace: each ray stops at its first accepted hit (the
    semantics rtk_trace_ray_filter promises, rtk.c:579-582)."""
    return _trace(scene, rays, "any", filter_fn, config)


def wide_depth(scene, roots=(0,)) -> int:
    """Levels of wide nodes below `roots` in the deepest tree: a traversal
    holds at most depth * (W - 1) stack entries."""
    child = scene.node_child.cpu().numpy()
    rows = np.asarray(roots, np.int64).reshape(-1)
    depth = 0
    while rows.size:
        if depth > child.shape[0]:
            raise ValueError("wide node table has a cycle")
        depth += 1
        c = child[rows]
        rows = c[c >= 0].astype(np.int64)
    return depth
