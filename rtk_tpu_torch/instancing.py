"""Two-level TLAS/BLAS instancing (rtk_tpu.instancing in PyTorch).

  * All BLAS scenes merge into ONE concatenated node/triangle space (child
    and leaf ids offset per BLAS), so one traversal serves every instance:
    the per-ray BLAS root is just a start row.
  * The top level tests each ray against every instance's world box and
    keeps its nearest C instance candidates by AABB entry distance: on the
    card one launch of csrc/candidates.cu (candidates_kernel, one thread a
    ray, the nearest list in registers), on the CPU the plain dense
    (rays x instances) slab (_instance_candidates_impl).
  * Candidate rounds walk them nearest-first: a ray transforms into the
    candidate's object space (affine inverse, direction unnormalised so
    object-space t == world-space t) and traces the merged BLAS from that
    instance's root with its current best t as the upper bound.
  * A ray whose (C+1)-th candidate still enters before its best hit is
    unproven and re-traces over all instances (the exactness residual).

trace_closest_instanced_packets traces each round through trace_packets'
rooted path with a root row per ray: the CUDA kernel's roots variant for
tensors on the card, its plain version for CPU tensors.  pack_instanced
checks the packed root rows once, on the host, so a round's launch makes
no host sync to check the roots it gathers from them.  A round takes only
the rays still live for it, grouped by instance as a coherence order; the
TPU's padding of each instance's rays to whole 128-ray packets (one root
per packet) is not needed when every thread carries its own root.

InstancedTracer puts an instanced scene where render_path takes a Tracer:
its closest is trace_closest_instanced_packets, whose record carries the
hit instance and the instance table, so that the shade pass maps the
object-space normal to world space.

Spans (utils/stats.py::span): `rtk.instanced.trace` (an instanced closest
call), `rtk.instanced.candidates` (the slab: on the card the kernel's
checks, outputs and launch; the residual's all-instance slab too),
`rtk.instanced.round` (a candidate round, from its live count's host sync
to the scatter of its hits; a round with no live ray ends at the sync)
and `rtk.instanced.residual` (the exactness residual).  Inside a round,
in order: `rtk.instanced.live` (the live mask and its `nonzero` sync, all
that an empty round holds), `rtk.instanced.rays` (the sort by instance,
the round cap, the object rays and the gathers of best t and roots), the
rooted trace's own `rtk.packet_trace`, and `rtk.instanced.scatter` (the
better hits written back).  A round's object rays and its scatter are, on
the card, one launch each of csrc/rounds.cu (round_rays_kernel,
round_scatter_kernel: no mask and no host sync); for CPU tensors and
plain=True their plain versions (round_rays_reference: _object_rays and
the eager gathers; round_scatter_reference: the better hits'
boolean-mask indexes and index-puts).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from rtk_tpu_torch.config import TraceConfig
from rtk_tpu_torch.ops import library
from rtk_tpu_torch.ops.packet_trace import (DEFAULT_P, PKT, PLAIN,
                                            _trace_rooted, front_steps)
from rtk_tpu_torch.scene import Scene
from rtk_tpu_torch.trace import stack as _stack
from rtk_tpu_torch.types import Hits, PacketHits, Rays
from rtk_tpu_torch.utils.stats import span

# trace_closest_instanced_packets in this process: INSTANCED_TRACES calls,
# INSTANCED_ROUNDS candidate rounds launched, INSTANCED_ROWS the rows they
# traced, INSTANCED_SYNCS the host syncs of this module's own and
# INSTANCED_RESIDUAL the rays the residual re-traced over all instances.
# INSTANCED_SYNCS counts, beside the statements that make them, the syncs
# on the card: each `nonzero`, each boolean-mask index of a device tensor
# (a `nonzero` inside), the auto caps' `tolist`, and in a round a cap
# cuts `bincount`'s two reads and a Python scalar index-put's copy.  A
# round syncs once for its live count, and six times more if it launches
# on the plain route (its scatter's masks; the card's scatter makes none);
# the residual once, then as the plain rounds do.  The stack engine's
# steps in the residual sync on their own, uncounted here.  A run resets
# them and reads them back, as ops/packet_trace.py's launch counters.
# CANDIDATE_LAUNCHES counts launches of the candidate slab's kernel
# (candidates_kernel): one an instanced trace on the card, and one a
# residual that re-traces rays.  ROUND_LAUNCHES counts launches of the
# rounds' two kernels (round_rays_kernel, round_scatter_kernel): two a
# launched round on the card, none on the plain route.
INSTANCED_TRACES = 0
INSTANCED_ROUNDS = 0
INSTANCED_ROWS = 0
INSTANCED_SYNCS = 0
INSTANCED_RESIDUAL = 0
CANDIDATE_LAUNCHES = 0
ROUND_LAUNCHES = 0

@dataclasses.dataclass
class InstancedScene:
    """Merged BLAS forest + instance table, all tensors on one device."""

    merged: Scene  # concatenated BLAS scenes (multi-root)
    roots: torch.Tensor  # (B,) i32 root row of each BLAS in `merged`
    instance_blas: torch.Tensor  # (I,) i32
    world_from_object: torch.Tensor  # (I, 3, 4) affine
    object_from_world: torch.Tensor  # (I, 3, 4) affine inverse
    inst_lo: torch.Tensor  # (I, 3) world AABB of each instance
    inst_hi: torch.Tensor  # (I, 3)
    blas_tris: tuple = ()  # real triangle count per BLAS
    blas_slots: tuple = ()  # padded triangle rows per BLAS in `merged`
    # Stack entries a stack-engine traversal of the deepest BLAS can need.
    max_stack: int = 0

    @property
    def num_instances(self) -> int:
        return self.instance_blas.shape[0]

    @property
    def total_triangles(self) -> int:
        """Effective triangle count: sum over instances of their BLAS size."""
        if not self.blas_tris:
            return 0
        counts = np.asarray(self.blas_tris)
        return int(counts[self.instance_blas.cpu().numpy()].sum())

    @property
    def device(self) -> torch.device:
        return self.instance_blas.device


def _affine_inverse(m: np.ndarray) -> np.ndarray:
    """(3,4) world-from-object -> (3,4) object-from-world."""
    lin = m[:, :3]
    t = m[:, 3]
    inv = np.linalg.inv(lin)
    return np.concatenate([inv, (-inv @ t)[:, None]], axis=1)


def merge_blas(scenes: Sequence[Scene]) -> tuple[Scene, np.ndarray]:
    """Concatenate BLAS Scenes into one multi-root Scene.

    All scenes must share leaf_size and branching and carry the wide node
    arrays.  Returns (merged, roots): roots[b] is BLAS b's root row."""
    k = scenes[0].leaf_size
    w = scenes[0].branching
    for s in scenes:
        if s.leaf_size != k or s.branching != w:
            raise ValueError("BLAS scenes must share leaf_size/branching")
        if not s.has_wide:
            # The merge offsets binary AND wide ids by node_child row
            # counts (equal only when the wide arrays are real), and the
            # exactness residual runs the stack engine, which needs them.
            raise ValueError(
                "BLAS scenes must be built with wide_nodes=True "
                "(the instanced path's stack-engine residual and the "
                "merge offsets need the wide node arrays)")

    node_off = np.cumsum([0] + [s.node_child.shape[0] for s in scenes])
    leaf_off = np.cumsum([0] + [s.num_padded_tris // k for s in scenes])
    tri_off = np.cumsum([0] + [s.num_padded_tris for s in scenes])

    def shifted(name):
        # Internal ids move by node_off[b], leaf codes -(l)-2 by leaf_off[b].
        return torch.cat([
            torch.where(c >= 0, c + int(node_off[b]),
                        torch.where(c <= -2, c - int(leaf_off[b]), c))
            for b, c in enumerate(getattr(s, name) for s in scenes)])

    def cat(name, per_blas=lambda a, b: a):
        return torch.cat([per_blas(getattr(s, name), b)
                          for b, s in enumerate(scenes)])

    merged = Scene(
        node_child=shifted("node_child"),
        node_min=cat("node_min"),
        node_max=cat("node_max"),
        bin_left=shifted("bin_left"),
        bin_right=shifted("bin_right"),
        bin_lo=cat("bin_lo", lambda a, b: a + int(leaf_off[b])),
        bin_hi=cat("bin_hi", lambda a, b: a + int(leaf_off[b])),
        bin_min=cat("bin_min"),
        bin_max=cat("bin_max"),
        leaf_min=cat("leaf_min"),
        leaf_max=cat("leaf_max"),
        tri_v=cat("tri_v"),
        tri_vidx=cat("tri_vidx"),
        tri_mesh=cat("tri_mesh"),
        tri_prim=cat("tri_prim"),
        perm=cat("perm", lambda a, b: torch.where(a >= 0, a + int(tri_off[b]),
                                                  -1)),
        bounds_min=functools.reduce(torch.minimum,
                                    [s.bounds_min for s in scenes]),
        bounds_max=functools.reduce(torch.maximum,
                                    [s.bounds_max for s in scenes]),
        num_tris=int(tri_off[-1]),  # padding rows are degenerate: harmless
        leaf_size=k,
        branching=w,
        num_leaves=int(leaf_off[-1]),
    )
    return merged, node_off[:-1].astype(np.int32)


def build_instanced(blas: Sequence[Scene], instance_blas,
                    transforms) -> InstancedScene:
    """Assemble an InstancedScene on the BLAS scenes' device.

    Args:
      blas: unique BLAS Scenes.
      instance_blas: (I,) int, BLAS index per instance.
      transforms: (I, 3, 4) world-from-object affine per instance.
    """
    merged, roots = merge_blas(blas)
    dev = merged.device
    instance_blas = np.asarray(instance_blas, np.int32).reshape(-1)
    if not instance_blas.size or not (
            0 <= instance_blas.min() and instance_blas.max() < len(blas)):
        raise ValueError(f"instance_blas must name at least one instance "
                         f"and index the {len(blas)} BLAS")
    transforms = np.asarray(transforms, np.float32).reshape(-1, 3, 4)
    inv = np.stack([_affine_inverse(m) for m in transforms]).astype(np.float32)

    # World AABB per instance: transform the 8 corners of the BLAS bounds.
    lo = np.stack([blas[b].bounds_min.cpu().numpy() for b in instance_blas])
    hi = np.stack([blas[b].bounds_max.cpu().numpy() for b in instance_blas])
    bits = ((np.arange(8)[:, None] >> np.arange(3)) & 1).astype(bool)
    corners = np.where(bits[None], hi[:, None], lo[:, None])  # (I, 8, 3)
    world = (np.einsum("iab,icb->ica", transforms[:, :, :3], corners)
             + transforms[:, None, :, 3])
    f32 = dict(dtype=torch.float32, device=dev)
    return InstancedScene(
        merged=merged,
        roots=torch.as_tensor(roots, device=dev),
        instance_blas=torch.as_tensor(instance_blas, device=dev),
        world_from_object=torch.as_tensor(transforms, **f32),
        object_from_world=torch.as_tensor(inv, **f32),
        inst_lo=torch.as_tensor(world.min(axis=1), **f32),
        inst_hi=torch.as_tensor(world.max(axis=1), **f32),
        blas_tris=tuple(int(s.num_tris) for s in blas),
        blas_slots=tuple(int(s.num_padded_tris) for s in blas),
        max_stack=_stack.wide_depth(merged, roots) * (merged.branching - 1),
    )


def _instance_candidates_impl(lo, hi, rays: Rays, c: int):
    """Nearest-C boxes per ray by AABB entry distance: a dense (rays x
    boxes) slab test over ray chunks, C passes of masked argmin (the first
    box on ties).  lo, hi: (B, 3) box corners on the rays' device (the
    instances' world boxes here, the subtree bins' in testing/binned.py,
    as the reference shares _instance_candidates_impl).

    Returns (cand_idx (N, C) i32 [-1 = none], cand_t (N, C) f32 [inf =
    none], overflow (N,) f32: the (C+1)-th entry distance, the exactness
    bound of the cap)."""
    n = rays.count
    n_inst = lo.shape[0]
    c = min(c, n_inst)
    chunk = max(1024, (1 << 24) // n_inst)  # bounds the (chunk, B) slab
    lo, hi = lo[None], hi[None]
    outs = []
    for s in range(0, max(n, 1), chunk):
        o = rays.origin[s:s + chunk, None]
        d = rays.direction[s:s + chunk]
        # NaN-free clamped reciprocal (finite huge instead of inf): a zero
        # direction component against a touching plane would give 0 * inf.
        big = torch.where(d >= 0, 3.0e38, -3.0e38)
        rcp = torch.where(d == 0.0, big, 1.0 / d)[:, None]
        t0 = (lo - o) * rcp
        t1 = (hi - o) * rcp
        near = torch.fmin(t0, t1)
        far = torch.fmax(t0, t1)
        enter = torch.fmax(torch.fmax(near[..., 0], near[..., 1]),
                           torch.fmax(near[..., 2],
                                      rays.min_t[s:s + chunk, None]))
        exit_ = torch.fmin(torch.fmin(far[..., 0], far[..., 1]),
                           torch.fmin(far[..., 2],
                                      rays.max_t[s:s + chunk, None]))
        score = torch.where(enter <= exit_, enter, float("inf"))
        idxs, ts = [], []
        for _ in range(c):
            v, j = score.min(dim=1)
            idxs.append(torch.where(torch.isfinite(v), j, -1))
            ts.append(v)
            score.scatter_(1, j[:, None], float("inf"))
        outs.append((torch.stack(idxs, 1).to(torch.int32),
                     torch.stack(ts, 1), score.min(dim=1).values))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def candidates_kernel(lo, hi, rays: Rays, c: int):
    """_instance_candidates_impl on the card: one launch of the library's
    rtk_instance_candidates (csrc/candidates.cu) on the current stream,
    with no host sync, for any c; its outputs (torch.empty) equal the
    plain version's on the same CUDA tensors bit for bit.  lo, hi: (B, 3)
    f32 box corners; the rays' origin and direction (N, 3) and min_t and
    max_t (N,) f32; every tensor contiguous, on one CUDA device.  Raises
    before the launch on any other input."""
    global CANDIDATE_LAUNCHES
    dev, f32, check = lo.device, torch.float32, library.check_tensor
    check(lo, "lo", f32, (None, 3), dev)
    n_box, n = lo.shape[0], rays.count
    check(hi, "hi", f32, (n_box, 3), dev)
    check(rays.origin, "origin", f32, (n, 3), dev)
    check(rays.direction, "direction", f32, (n, 3), dev)
    check(rays.min_t, "min_t", f32, (n,), dev)
    check(rays.max_t, "max_t", f32, (n,), dev)
    if not all(a.is_contiguous() for a in (lo, hi, rays.origin,
                                           rays.direction, rays.min_t,
                                           rays.max_t)):
        raise ValueError("candidates_kernel takes contiguous tensors")
    if not n_box or c < 1:
        raise ValueError(f"candidates_kernel needs a box and c >= 1, not "
                         f"{n_box} boxes and c = {c}")
    if dev.type != "cuda":
        raise ValueError("candidates_kernel takes CUDA tensors; the plain "
                         "version is _instance_candidates_impl")
    c = min(int(c), n_box)
    cand_idx = torch.empty((n, c), dtype=torch.int32, device=dev)
    cand_t = torch.empty((n, c), dtype=f32, device=dev)
    overflow = torch.empty((n,), dtype=f32, device=dev)
    if n:
        library.launch(dev, "rtk_instance_candidates", _candidates_call,
                       library.load_kernel(), lo, hi, rays, c, cand_idx,
                       cand_t, overflow)
        CANDIDATE_LAUNCHES += 1
    return cand_idx, cand_t, overflow


def _candidates_call(lib, lo, hi, rays, c, cand_idx, cand_t, overflow,
                     stream):
    """rtk_instance_candidates of contiguous f32 boxes and rays into the
    contiguous outputs -> its error code."""
    return lib.rtk_instance_candidates(
        lo.data_ptr(), hi.data_ptr(), lo.shape[0], rays.origin.data_ptr(),
        rays.direction.data_ptr(), rays.min_t.data_ptr(),
        rays.max_t.data_ptr(), rays.count, c, cand_idx.data_ptr(),
        cand_t.data_ptr(), overflow.data_ptr(), stream)


def _instance_candidates(iscene: InstancedScene, rays: Rays, c: int):
    """The nearest-c instance boxes of each ray, as
    _instance_candidates_impl gives them over the instances' world boxes:
    candidates_kernel for rays on the card, the plain version on the
    CPU."""
    with span("rtk.instanced.candidates"):
        if rays.device.type == "cuda":
            return candidates_kernel(
                iscene.inst_lo, iscene.inst_hi,
                Rays(*(a.contiguous() for a in (
                    rays.origin, rays.direction, rays.min_t, rays.max_t))),
                c)
        return _instance_candidates_impl(iscene.inst_lo, iscene.inst_hi,
                                         rays, c)


def _object_rays(object_from_world, origin, direction):
    """World rays -> object space of per-ray (N, 3, 4) affines: each
    component a fixed sum of products, the same bits on every device."""
    m = object_from_world
    o = (m[:, :, 0] * origin[:, 0:1] + m[:, :, 1] * origin[:, 1:2]
         + m[:, :, 2] * origin[:, 2:3] + m[:, :, 3])
    d = (m[:, :, 0] * direction[:, 0:1] + m[:, :, 1] * direction[:, 1:2]
         + m[:, :, 2] * direction[:, 2:3])
    return o, d


def round_rays_reference(rows, inst, origin, direction, min_t, best_t,
                         object_from_world, instance_blas, packed_roots):
    """A candidate round's rays in object space, the plain version: rows
    (M,) ray indices and inst (M,) their instances (int64, in the round's
    order); the frame's world origin and direction (N, 3), min_t and
    best_t (N,); the instance table's object_from_world (I, 3, 4) and
    instance_blas (I,), and pack_instanced's packed_roots (B,) -> (Rays:
    object-space origin and direction, min t, max t = best t; (M,) i32
    roots; the instances).  The roots are gathered from pack_instanced's
    checked rows by instance ids in range, so the traversal's launch makes
    no host sync to check them."""
    o, d = _object_rays(object_from_world[inst], origin[rows],
                        direction[rows])
    return (Rays(o, d, min_t[rows], best_t[rows]),
            packed_roots[instance_blas[inst]], inst)


def round_rays_kernel(rows, inst, origin, direction, min_t, best_t,
                      object_from_world, instance_blas, packed_roots):
    """round_rays_reference on the card: one launch of the library's
    rtk_instanced_round_rays (csrc/rounds.cu) on the current stream, with
    no host sync; its outputs (torch.empty, contiguous) equal the plain
    version's bit for bit, the instances as i32.  rows, inst: int64;
    object_from_world, origin, direction, min_t, best_t: f32;
    instance_blas, packed_roots: i32; every tensor contiguous, on one CUDA
    device, and every id in range.  Raises before the launch on any other
    input."""
    global ROUND_LAUNCHES
    dev, f32, i32, check = rows.device, torch.float32, torch.int32, \
        library.check_tensor
    check(rows, "rows", torch.int64, (None,), dev)
    m = rows.shape[0]
    check(inst, "inst", torch.int64, (m,), dev)
    check(origin, "origin", f32, (None, 3), dev)
    n = origin.shape[0]
    check(direction, "direction", f32, (n, 3), dev)
    check(min_t, "min_t", f32, (n,), dev)
    check(best_t, "best_t", f32, (n,), dev)
    check(object_from_world, "object_from_world", f32, (None, 3, 4), dev)
    check(instance_blas, "instance_blas", i32,
          (object_from_world.shape[0],), dev)
    check(packed_roots, "packed_roots", i32, (None,), dev)
    ins = (rows, inst, origin, direction, min_t, best_t, object_from_world,
           instance_blas, packed_roots)
    if not all(a.is_contiguous() for a in ins):
        raise ValueError("round_rays_kernel takes contiguous tensors")
    if dev.type != "cuda":
        raise ValueError("round_rays_kernel takes CUDA tensors; the plain "
                         "version is round_rays_reference")
    o = torch.empty((m, 3), dtype=f32, device=dev)
    d = torch.empty_like(o)
    lo, hi = (torch.empty((m,), dtype=f32, device=dev) for _ in range(2))
    roots, inst32 = (torch.empty((m,), dtype=i32, device=dev)
                     for _ in range(2))
    if m:
        library.launch(dev, "rtk_instanced_round_rays", _round_rays_call,
                       library.load_kernel(), *ins, o, d, lo, hi, roots,
                       inst32)
        ROUND_LAUNCHES += 1
    return Rays(o, d, lo, hi), roots, inst32


def _round_rays_call(lib, rows, inst, *tensors):
    """rtk_instanced_round_rays of round_rays_kernel's contiguous rows,
    inst and seven more inputs into its six outputs (the stream last) ->
    its error code."""
    *ts, stream = tensors
    return lib.rtk_instanced_round_rays(
        rows.data_ptr(), inst.data_ptr(), rows.shape[0],
        *(a.data_ptr() for a in ts), stream)


def round_scatter_reference(rows, hit, t, u, v, slot, bt, inst, best):
    """A candidate round's better hits written back, the plain version:
    where hit & (t < bt), best's "t", "u", "v", "slot" and "inst" at rows
    take the round's t, u, v, slot and inst, in place (six boolean-mask
    indexes and five index-puts; rows are distinct)."""
    global INSTANCED_SYNCS
    better = hit & (t < bt)
    r = rows[better]
    best["t"][r] = t[better]
    best["u"][r] = u[better]
    best["v"][r] = v[better]
    best["slot"][r] = slot[better]
    best["inst"][r] = inst[better].to(torch.int32)
    INSTANCED_SYNCS += 6  # the six boolean-mask indexes


def round_scatter_kernel(rows, hit, t, u, v, slot, bt, inst, best):
    """round_scatter_reference on the card: one launch of the library's
    rtk_instanced_round_scatter (csrc/rounds.cu) on the current stream,
    with no mask and no host sync; best's tensors after it equal the plain
    version's bit for bit.  rows: (M,) int64, distinct; hit: (M,) bool;
    t, u, v, bt: (M,) f32; slot, inst: (M,) i32; best: "t", "u", "v" (N,)
    f32 and "slot", "inst" (N,) i32; every tensor contiguous, on one CUDA
    device.  Raises before the launch on any other input."""
    global ROUND_LAUNCHES
    dev, f32, i32, check = rows.device, torch.float32, torch.int32, \
        library.check_tensor
    check(rows, "rows", torch.int64, (None,), dev)
    m = rows.shape[0]
    check(hit, "hit", torch.bool, (m,), dev)
    for name, a, dt in (("t", t, f32), ("u", u, f32), ("v", v, f32),
                        ("slot", slot, i32), ("bt", bt, f32),
                        ("inst", inst, i32)):
        check(a, name, dt, (m,), dev)
    out = [best[k] for k in ("t", "u", "v", "slot", "inst")]
    n = out[0].shape[0]
    for k, a in zip(("t", "u", "v", "slot", "inst"), out):
        check(a, f"best[{k!r}]", i32 if k in ("slot", "inst") else f32,
              (n,), dev)
    ins = (rows, hit, t, u, v, slot, bt, inst)
    if not all(a.is_contiguous() for a in (*ins, *out)):
        raise ValueError("round_scatter_kernel takes contiguous tensors")
    if dev.type != "cuda":
        raise ValueError("round_scatter_kernel takes CUDA tensors; the "
                         "plain version is round_scatter_reference")
    if m:
        library.launch(dev, "rtk_instanced_round_scatter",
                       _round_scatter_call, library.load_kernel(), *ins,
                       *out)
        ROUND_LAUNCHES += 1


def _round_scatter_call(lib, rows, *tensors):
    """rtk_instanced_round_scatter of round_scatter_kernel's contiguous
    rows, seven inputs and five best tensors (the stream last) -> its
    error code."""
    *ts, stream = tensors
    return lib.rtk_instanced_round_scatter(
        rows.data_ptr(), rows.shape[0], *(a.data_ptr() for a in ts), stream)


def _stack_config(iscene: InstancedScene, config: TraceConfig) -> TraceConfig:
    """The stack engine's config with a stack deep enough for every BLAS."""
    return dataclasses.replace(
        config, max_stack=max(config.max_stack, iscene.max_stack))


def trace_closest_instanced(iscene: InstancedScene, rays: Rays,
                            max_candidates: int = 8,
                            config: TraceConfig = TraceConfig()):
    """Closest hit over an instanced scene through the stack engine.

    Returns (hits, instance_index (N,) i32, -1 on miss).  Hit vertex
    positions are in the OBJECT space of the hit instance; t/u/v/mesh/
    triangle follow the usual contract and t is a world-space distance.
    The traversal stack is sized from the deepest BLAS (at least
    config.max_stack).
    """
    n = rays.count
    dev = rays.device
    cfg = _stack_config(iscene, config)
    cand_idx, cand_t, _ = _instance_candidates(iscene, rays, max_candidates)
    best = Hits(
        hit=torch.zeros((n,), dtype=torch.bool, device=dev),
        t=rays.max_t.clone(),
        u=torch.zeros((n,), device=dev),
        v=torch.zeros((n,), device=dev),
        mesh_index=torch.full((n,), -1, dtype=torch.int32, device=dev),
        triangle_index=torch.full((n,), -1, dtype=torch.int32, device=dev),
        vertex_position=torch.zeros((n, 3, 3), device=dev),
        vertex_index=torch.full((n, 3), -1, dtype=torch.int32, device=dev),
    )
    best_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for s in range(cand_idx.shape[1]):
        rows = torch.nonzero(cand_t[:, s] < best.t).squeeze(1)
        if not rows.numel():
            break
        inst = cand_idx[rows, s].long()
        o, d = _object_rays(iscene.object_from_world[inst],
                            rays.origin[rows], rays.direction[rows])
        h = _stack._trace_loop(
            iscene.merged, Rays(o, d, rays.min_t[rows], best.t[rows]),
            mode="closest", config=cfg,
            start_node=iscene.roots[iscene.instance_blas[inst]])
        better = h.hit & (h.t < best.t[rows])
        r = rows[better]
        for f in dataclasses.fields(Hits):
            getattr(best, f.name)[r] = getattr(h, f.name)[better]
        best_inst[r] = inst[better].to(torch.int32)
    return best, best_inst


# ---------------------------------------------------------------------------
# Packet-kernel instanced tracing.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedInstancedScene:
    iscene: InstancedScene
    packed: object  # PackedScene of the merged forest
    packed_roots: torch.Tensor  # (B,) i32 packed root row per BLAS
    # (merged Tp,) i32: packed slot of each triangle slot of iscene.merged
    # (the exactness residual traces `merged` and reports packed slots).
    slot_of_sorted: torch.Tensor


def _slot_of_sorted(iscene: InstancedScene, packed, soup_ids: bool):
    """Invert packed.tri_perm into a map from the merged Scene's triangle
    slots to packed slots.

    soup_ids: tri_perm holds ids into the BLAS soups laid end to end
    (build_sah_forest's tables) rather than merged slots (pack_forest's).
    Raises if the tables do not hold the BLAS list in order."""
    merged = iscene.merged
    dev = merged.device
    tri_perm = packed.tri_perm.to(torch.int64)
    if soup_ids:
        # soup id -> (BLAS b, id in b's soup) -> merged.perm's key for it
        # (the id offset by the padded rows of the BLAS before b) -> slot.
        real_off = torch.as_tensor(np.cumsum([0, *iscene.blas_tris]),
                                   device=dev)
        pad_off = torch.as_tensor(np.cumsum([0, *iscene.blas_slots]),
                                  device=dev)
        b = torch.searchsorted(real_off[1:], tri_perm, right=True)
        b = b.clamp(max=len(iscene.blas_tris) - 1)
        key = tri_perm - real_off[b] + pad_off[b]
        perm = merged.perm.to(torch.int64)
        sorted_of_key = torch.full((merged.num_padded_tris,), -1,
                                   dtype=torch.int64, device=dev)
        ok = perm >= 0
        sorted_of_key[perm[ok]] = torch.nonzero(ok).squeeze(1)
        tri_perm = torch.where(
            tri_perm >= 0,
            sorted_of_key[key.clamp(0, merged.num_padded_tris - 1)], -1)
    valid = tri_perm >= 0
    slots = torch.nonzero(valid).squeeze(1)
    out = torch.full((merged.num_padded_tris,), -1, dtype=torch.int32,
                     device=dev)
    out[tri_perm[valid]] = slots.to(torch.int32)
    if not torch.equal(merged.tri_prim[tri_perm[valid]],
                       packed.tri_prim[valid]):
        raise ValueError("the packed tables do not hold the instanced "
                         "scene's BLAS list in order")
    return out


def pack_instanced(iscene: InstancedScene, packed=None,
                   packed_roots=None) -> PackedInstancedScene:
    """Pack the merged BLAS forest for the packet kernel.

    packed/packed_roots: optional override tables from
    builder.sah.build_sah_forest over the same BLAS list in the same order
    (static BLAS geometry traced many times gains from the SAH topology as
    flat static scenes do); the record contract is unchanged."""
    from rtk_tpu_torch.trace.packed import pack_forest

    soup_ids = packed is not None
    if packed is None:
        packed, packed_roots = pack_forest(iscene.merged,
                                           iscene.roots.cpu().numpy())
    elif packed_roots is None:
        raise ValueError("pack_instanced(packed=...) needs packed_roots")
    # Checked here, once, on the host: the rounds launch the kernel from
    # these rows without a device-side check.
    roots = torch.as_tensor(packed_roots).cpu().numpy().astype(np.int64)
    rows = packed.nodes.shape[0] // packed.branching
    n_blas = iscene.roots.shape[0]
    if roots.shape != (n_blas,):
        raise ValueError(f"packed_roots must hold one row per BLAS "
                         f"({n_blas}), not shape {roots.shape}")
    if n_blas and (roots.min() < 0 or roots.max() >= rows):
        raise ValueError(f"packed_roots span [{roots.min()}, {roots.max()}]; "
                         f"the table has {rows} rows")
    return PackedInstancedScene(
        iscene=iscene, packed=packed,
        packed_roots=torch.as_tensor(roots, device=iscene.device).to(
            torch.int32),
        slot_of_sorted=_slot_of_sorted(iscene, packed, soup_ids))


def _grouped_size(n: int, n_inst: int, unit: int, p_pk: int):
    """(M, block) of the reference's grouped round layout: every ray plus
    up to unit-1 padding rows per instance, in whole blocks of p_pk
    packets.  round_caps are counted in its rows."""
    blk = p_pk * unit
    chunk = min(16384, max(1, n))
    np_ = n + ((-n) % chunk)
    return (np_ + n_inst * unit + blk - 1) // blk * blk, blk


def _pow2_cap(need: int, blk: int, m: int) -> int:
    q = blk
    while q < need:
        q *= 2
    return min(q, m)


def _residual_exhaustive(pscene: PackedInstancedScene, rays: Rays, best):
    """Exhaustive candidate rounds over ALL instances through the stack
    engine for the unproven rays (`rays`, `best` already compacted to
    them); the stack engine's merged slot maps to a packed slot."""
    global INSTANCED_SYNCS
    iscene = pscene.iscene
    cfg = _stack_config(iscene, TraceConfig())
    cand_idx, cand_t, _ = _instance_candidates(iscene, rays,
                                               iscene.num_instances)
    for s in range(cand_idx.shape[1]):
        rows = torch.nonzero(cand_t[:, s] < best["t"]).squeeze(1)
        INSTANCED_SYNCS += 1
        if not rows.numel():
            break
        inst = cand_idx[rows, s].long()
        o, d = _object_rays(iscene.object_from_world[inst],
                            rays.origin[rows], rays.direction[rows])
        h, sorted_slot = _stack._trace_loop(
            iscene.merged, Rays(o, d, rays.min_t[rows], best["t"][rows]),
            mode="closest", config=cfg,
            start_node=iscene.roots[iscene.instance_blas[inst]],
            return_slot=True)
        better = h.hit & (h.t < best["t"][rows])
        r = rows[better]
        best["t"][r] = h.t[better]
        best["u"][r] = h.u[better]
        best["v"][r] = h.v[better]
        best["slot"][r] = pscene.slot_of_sorted[sorted_slot[better].long()]
        best["inst"][r] = inst[better].to(torch.int32)
        INSTANCED_SYNCS += 6  # the six boolean-mask indexes


def _residual(pscene: PackedInstancedScene, rays: Rays, best,
              unproven) -> int:
    """The exactness residual: re-trace the unproven rays over all
    instances and update `best` in place -> how many rays it re-traced."""
    global INSTANCED_SYNCS, INSTANCED_RESIDUAL
    with span("rtk.instanced.residual"):
        idx = torch.nonzero(unproven).squeeze(1)
        INSTANCED_SYNCS += 1
        if idx.numel():
            sub = {k: v[idx] for k, v in best.items()}
            _residual_exhaustive(pscene, rays[idx], sub)
            for k, v in best.items():
                v[idx] = sub[k]
        INSTANCED_RESIDUAL += idx.numel()
        return idx.numel()


def _instanced_rounds(pscene: PackedInstancedScene, rays: Rays,
                      max_candidates: int, p_pk: int, round_caps, unit,
                      plain: bool):
    """trace_closest_instanced_packets up to its exactness residual: the
    candidate pass and the grouped rounds -> (best, unproven, live_counts,
    round_caps).  best: {"t", "u", "v", "slot", "inst"} per ray;
    unproven: (N,) bool, the rays the residual must re-trace (their
    (C+1)-th instance entry is still closer than their best hit, or a
    round cap cut them).  parallel/shard.py runs this on each ray shard
    and the residual once over the gathered unproven rays."""
    global INSTANCED_ROUNDS, INSTANCED_ROWS, INSTANCED_SYNCS
    iscene = pscene.iscene
    packed = pscene.packed
    if rays.device != iscene.device:
        raise ValueError(f"rays on {rays.device}, scene on {iscene.device}")
    n = rays.count
    dev = rays.device
    steps = front_steps(dev, plain)
    unit = PKT if unit is None else int(unit)
    n_inst = iscene.num_instances
    C = min(max_candidates, n_inst)
    M, blk = _grouped_size(n, n_inst, unit, p_pk)

    cand_idx, cand_t, overflow = _instance_candidates(iscene, rays, C)
    if round_caps == "auto":
        # Each round's rows bounded by its candidate-rank population
        # (ignores best-t evolution, so an upper bound on its live set).
        cnt = ((cand_idx >= 0) & (cand_t < rays.max_t[:, None])).sum(0)
        round_caps = tuple(
            _pow2_cap(c + unit * min(c, n_inst), blk, M)
            for c in cnt.tolist())
        INSTANCED_SYNCS += 1
    elif round_caps is not None:
        round_caps = tuple(int(c_) for c_ in round_caps)
        if len(round_caps) != C:
            raise ValueError(f"round_caps needs {C} entries")

    best = {"t": rays.max_t.clone(),
            "u": torch.zeros((n,), device=dev),
            "v": torch.zeros((n,), device=dev),
            "slot": torch.full((n,), -1, dtype=torch.int32, device=dev),
            "inst": torch.full((n,), -1, dtype=torch.int32, device=dev)}
    over_cap = torch.zeros((n,), dtype=torch.bool, device=dev)
    # A round's object rays and scatter run on the card where its trace
    # does (the kernels take contiguous world rays), else eagerly.
    round_glue = ((round_rays_kernel, round_scatter_kernel)
                  if steps is not PLAIN else
                  (round_rays_reference, round_scatter_reference))
    world = tuple(a.contiguous() for a in (rays.origin, rays.direction,
                                           rays.min_t))
    live_counts = []
    for s in range(C):
        with span("rtk.instanced.round"):
            with span("rtk.instanced.live"):
                live = cand_t[:, s] < best["t"]
                rows = torch.nonzero(live).squeeze(1)
                INSTANCED_SYNCS += 1
                live_counts.append(rows.numel())
            if not rows.numel():
                continue  # candidates are nearest-first: later rounds are empty
            with span("rtk.instanced.rays"):
                inst, order = torch.sort(cand_idx[rows, s].long(),
                                         stable=True)
                rows = rows[order]
                if round_caps is not None and round_caps[s] < M:
                    # Row of each live ray in the reference's grouped layout.
                    counts = torch.bincount(inst, minlength=n_inst)
                    INSTANCED_SYNCS += 2  # on the card: its min and its max
                    padded = (counts + unit - 1) // unit * unit
                    pos = ((torch.cumsum(padded, 0) - padded)[inst]
                           + torch.arange(rows.numel(), device=dev)
                           - (torch.cumsum(counts, 0) - counts)[inst])
                    keep = pos < round_caps[s]
                    over_cap[rows[~keep]] = True
                    rows, inst = rows[keep], inst[keep]
                    # The three boolean-mask indexes, and True copied to
                    # the card for the index-put.
                    INSTANCED_SYNCS += 4
                round_rays, roots, inst = round_glue[0](
                    rows, inst, *world, best["t"], iscene.object_from_world,
                    iscene.instance_blas, pscene.packed_roots)
            h = _trace_rooted(steps, packed, round_rays, roots)
            INSTANCED_ROUNDS += 1
            INSTANCED_ROWS += rows.numel()
            with span("rtk.instanced.scatter"):
                round_glue[1](rows, h.hit, h.t, h.u, h.v, h.slot,
                              round_rays.max_t, inst, best)

    # A ray whose (C+1)-th instance entry is still closer than its best hit
    # is unproven, and so is one a round cap cut.
    return best, (overflow < best["t"]) | over_cap, live_counts, round_caps


def trace_closest_instanced_packets(
        pscene: PackedInstancedScene, rays: Rays, max_candidates: int = 8,
        interpret: bool = False, exact: bool = True, leaf_loop: bool = False,
        ordered: bool = False, p_pk: int = DEFAULT_P, round_caps=None,
        return_live_counts: bool = False, unit: int | None = None,
        plain: bool = False, stats: dict | None = None):
    """Closest hit over an instanced scene through the packet traversal.

    Per candidate round s: the rays whose s-th candidate enters before
    their best hit (cand_t[:, s] < best_t), grouped by instance, move to
    that instance's object space and trace the packed forest from its
    BLAS root (trace_packets with ray_roots); improvements scatter back.

    Returns (PacketHits, instance_index (N,) i32), plus the per-round live
    counts (C,) with return_live_counts.  Hit vertex positions are in the
    OBJECT space of the hit instance; position() and t are world-space.
    The record carries instance_index and the instances' object_from_world
    (PacketHits.instance, .object_from_world).

    exact: rays the C-candidate cap cannot prove, and live rows a round
      cap cut, re-trace over all instances (_residual_exhaustive).
    round_caps: None, "auto" (from the candidate-rank populations) or C
      row capacities in the reference's grouped layout (unit-ray packets
      per instance, p_pk packets per block): live rows past a round's cap
      go to the residual.  With exact=True no cap changes the result.
    plain: run every round through the kernel's plain version
      (trace_packets_reference) and the rounds' eager glue
      (round_rays_reference, round_scatter_reference) on any device.
    stats: optional dict, filled with "live_counts", "caps" and
      "residual" (the number of rays re-traced exhaustively).
    interpret, leaf_loop and ordered pick the TPU kernel's schedule and
    have no effect here.
    """
    global INSTANCED_TRACES
    packed = pscene.packed
    with span("rtk.instanced.trace"):
        best, unproven, live_counts, round_caps = _instanced_rounds(
            pscene, rays, max_candidates, p_pk, round_caps, unit, plain)
        n_res = _residual(pscene, rays, best, unproven) if exact else 0
    INSTANCED_TRACES += 1
    if stats is not None:
        stats.update(live_counts=live_counts, caps=round_caps,
                     residual=n_res)

    hits = PacketHits(
        hit=best["slot"] >= 0, t=best["t"], u_k=best["u"], v_k=best["v"],
        slot=best["slot"],
        # World rays: position() is the world-space hit point.
        origin=rays.origin, direction=rays.direction,
        tri_v=packed.tri_v, tri_vidx=packed.tri_vidx,
        tri_mesh=packed.tri_mesh, tri_prim=packed.tri_prim,
        instance=best["inst"],
        object_from_world=pscene.iscene.object_from_world)
    if return_live_counts:
        return hits, best["inst"], torch.tensor(live_counts)
    return hits, best["inst"]


@dataclasses.dataclass
class InstancedBounds:
    """The union of an instanced scene's world boxes: what render_path
    reads of a Tracer's scene (its sort key's bounds)."""

    bounds_min: torch.Tensor  # (3,) f32
    bounds_max: torch.Tensor  # (3,) f32


class InstancedTracer:
    """An instanced scene where render_path takes a Tracer.

    closest(rays) is trace_closest_instanced_packets(pscene, rays,
    max_candidates=...): exact (the residual re-traces what the candidate
    cap cannot prove), with no round caps, and its record carries the hit
    instance, so that the shade pass maps the object-space normal to world
    space.  scene.bounds_min / bounds_max: the union of the instances'
    world boxes."""

    def __init__(self, pscene: PackedInstancedScene, max_candidates: int = 8):
        self.pscene = pscene
        self.max_candidates = int(max_candidates)
        iscene = pscene.iscene
        self.scene = InstancedBounds(iscene.inst_lo.amin(dim=0),
                                     iscene.inst_hi.amax(dim=0))

    def closest(self, rays: Rays, coherent: bool | None = None) -> PacketHits:
        """Nearest hit over every instance.  `coherent` is the reference
        engine's stepping hint, accepted as Tracer.closest accepts it."""
        return trace_closest_instanced_packets(
            self.pscene, rays, max_candidates=self.max_candidates)[0]


def calibrate_round_caps(pscene: PackedInstancedScene, rays: Rays,
                         max_candidates: int = 8, margin: float = 1.5,
                         p_pk: int = DEFAULT_P, unit: int | None = None,
                         **kw):
    """round_caps for later traces from one uncapped trace's per-round
    live counts (cand_t[s] < best_t as best evolves), margin x measured,
    quantised to powers of two of a block.  A hotter later batch only
    sends rows to the exactness residual; it never loses a hit."""
    _, _, counts = trace_closest_instanced_packets(
        pscene, rays, max_candidates=max_candidates, p_pk=p_pk,
        return_live_counts=True, unit=unit, **kw)
    return caps_from_counts(counts.numpy(), rays.count,
                            pscene.iscene.num_instances, margin=margin,
                            p_pk=p_pk, unit=unit)


def caps_from_counts(counts, n: int, n_inst: int, margin: float = 1.5,
                     p_pk: int = DEFAULT_P, unit: int | None = None):
    """round_caps tuple from measured per-round live counts (callers that
    pool counts over several batches take an elementwise max first)."""
    unit = PKT if unit is None else int(unit)
    M, blk = _grouped_size(n, n_inst, unit, p_pk)
    return tuple(
        _pow2_cap(int(int(c) * margin) + unit * min(int(c), n_inst), blk, M)
        for c in counts)
