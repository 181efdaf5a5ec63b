"""Wavefront path tracing on top of the ray-query engine
(rtk_tpu.models.path).

The rendering workloads the library exists for: incoherent bounce
batches, stream-compacted and re-sorted between bounces so the traversal
kernel stays fed with coherent work.

Structure: a host-driven wavefront loop.  Each bounce is a trace, then a
shade / sample / key pass and a sort by that key; between
bounces rays are compacted to the live prefix (dropping finished rays
shrinks the next launch; ray counts are bucketed to powers of two) and
optionally sorted by a Morton key of origin and direction octant to
restore coherence.  Random draws come from a torch.Generator where
rtk_tpu takes a JAX key; `_shade_sample` and `cosine_sample` also take
the uniforms as given, so the same uniforms give the same image, and
`render_path(uniforms=...)` takes them by ray and bounce, so that a
path's radiance does not depend on compaction, buckets or the sort.

The shade pass runs in
  * `shade_kernel`: the hand-written CUDA kernel (csrc/shade.cu, one
    thread a ray, built into the traversal's library), for CUDA tensors;
    it reads the hit record through one row into the triangle tables (a
    PacketHits' slot, a plain Hits' own row), so every engine's records
    go through it;
  * `_shade_sample`: the plain version in eager PyTorch, for CPU tensors.
The two agree bit for bit on every output of every ray.  A CUDA tensor
always goes to the kernel: a build or launch failure raises, it never
falls back.

Spans (utils/stats.py::span): `rtk.path.render` (the call),
`rtk.path.trace` and `rtk.path.shade` (each bounce) and
`rtk.path.compact` (the live count's host sync and the take).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from rtk_tpu_torch.ops import library
from rtk_tpu_torch.ops.morton import morton3d
from rtk_tpu_torch.tracer import Tracer
from rtk_tpu_torch.types import PacketHits, Rays, _f32
from rtk_tpu_torch.utils.stats import span

_LIVE_MAX_T = float(np.float32(3.4e38))  # a live bounce ray's max_t
_MIN_THROUGHPUT = 1e-5  # a path below it in every channel ends

# render_path in this process: PATH_TRACES traces launched, PATH_ROWS the
# rows they launched (the sum of the batch sizes, buckets included) and
# PATH_SYNCS host syncs (the live count of a compacted bounce).  A run
# resets them and reads them back, as ops/packet_trace.py's launch counters.
# SHADE_LAUNCHES counts launches of the shade kernel (shade_kernel), one
# a bounce of a render on the card.
PATH_TRACES = 0
PATH_ROWS = 0
PATH_SYNCS = 0
SHADE_LAUNCHES = 0


@dataclasses.dataclass
class Materials:
    """Per-mesh lambertian materials (indexed by Hits.mesh_index)."""

    albedo: torch.Tensor  # (M, 3) f32
    emission: torch.Tensor  # (M, 3) f32

    @staticmethod
    def make(albedo, emission=None, device=None) -> "Materials":
        """device: default the albedo tensor's device, else the card."""
        if device is None:
            device = (albedo.device if isinstance(albedo, torch.Tensor)
                      else "cuda")
        albedo = _f32(albedo, device).reshape(-1, 3)
        if emission is None:
            emission = torch.zeros_like(albedo)
        else:
            emission = _f32(emission, device).reshape(-1, 3)
        return Materials(albedo=albedo, emission=emission)


def world_normal(n: torch.Tensor, instance: torch.Tensor,
                 object_from_world: torch.Tensor) -> torch.Tensor:
    """Object-space normals (N, 3) of an instanced record to world space:
    L^T n with L the linear part of the hit instance's object_from_world
    (the inverse transpose of its world_from_object), each component a
    fixed sum of products.  instance (N,) is clamped to the table (a miss's
    -1 reads instance 0).  Not normalised."""
    k = instance.clamp(0, object_from_world.shape[0] - 1).long()
    m = object_from_world[k]
    return (m[:, 0, :3] * n[:, 0:1] + m[:, 1, :3] * n[:, 1:2]
            + m[:, 2, :3] * n[:, 2:3])


def geometric_normal(hits, direction: torch.Tensor) -> torch.Tensor:
    """Unit geometric normal of each hit triangle, flipped to face the
    incoming ray. (N, 3).  An instanced record's (hits.instance set) is
    mapped from the hit instance's object space to world space first."""
    v = hits.vertex_position
    n = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    instance = getattr(hits, "instance", None)
    if instance is not None:
        n = world_normal(n, instance, hits.object_from_world)
    n = n / torch.linalg.vector_norm(n, dim=1, keepdim=True).clamp_min(1e-20)
    flip = (n * direction).sum(dim=1, keepdim=True) > 0
    return torch.where(flip, -n, n)


def cosine_sample(generator: torch.Generator | None, normal: torch.Tensor,
                  u1: torch.Tensor | None = None,
                  u2: torch.Tensor | None = None) -> torch.Tensor:
    """Cosine-weighted hemisphere directions around unit normals. (N, 3).

    The two uniforms a direction are drawn from `generator` (a
    torch.Generator on the normals' device; None: torch's default), or
    taken as given: u1, u2 (N,) in [0, 1).  rtk_tpu draws them from a JAX
    key; the same uniforms give the same directions."""
    n = normal.shape[0]
    if u1 is None or u2 is None:
        u1, u2 = torch.rand((2, n), generator=generator,
                            device=normal.device, dtype=torch.float32)
    u1 = torch.as_tensor(u1, dtype=torch.float32, device=normal.device)
    u2 = torch.as_tensor(u2, dtype=torch.float32, device=normal.device)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    # Orthonormal basis around the normal (branchless, Frisvad style).
    nx, ny, nz = normal.unbind(dim=1)
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t1 = torch.stack([1.0 + sign * nx ** 2 * a, sign * b, -sign * nx], dim=1)
    t2 = torch.stack([b, sign + ny ** 2 * a, -ny], dim=1)
    return (x[:, None] * t1 + y[:, None] * t2
            + z[:, None] * normal).to(torch.float32)


def _ray_sort_key(rays: Rays, lo, hi) -> torch.Tensor:
    """Coherence key: direction octant (3 bits) above a Morton code of the
    origin, the bounce-ray reordering of the wavefront design.

    int32 where rtk_tpu's is uint32: the octant sits at bits 24-26 and the
    caller's dead flag at bit 28, so every value is a positive int32 equal
    to the reference's."""
    code = morton3d(rays.origin, lo, hi, bits=8)  # 24 bits
    pos = (rays.direction >= 0).to(torch.int32)
    octant = pos[:, 0] | (pos[:, 1] << 1) | (pos[:, 2] << 2)
    return (octant << 24) | code


def _round_up_bucket(n: int, minimum: int) -> int:
    """Next power-of-two bucket.  rtk_tpu buckets to bound recompiles;
    nothing compiles per shape here, but the bucket still fixes the batch
    sizes a bounce launches (few distinct sizes for the caching allocator
    to hold), and the dead rays it keeps at the back of a batch are part
    of what compact=True returns slot for slot."""
    return max(minimum, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


def _shade_sample(hits, cur: Rays, throughput, index, radiance,
                  materials: Materials, generator, bg, lo, hi, *, epsilon,
                  sort_rays, last, u1=None, u2=None):
    """Shade, importance-sample and build the sort permutation for one
    bounce.  radiance is updated in place (and returned); `index` holds no
    duplicates, so the scatter-add is deterministic.  generator, u1, u2:
    cosine_sample's.  -> radiance if last, else (radiance, next rays,
    throughput, perm, number alive (a 0-d tensor))."""
    hit = hits.hit
    mesh = hits.mesh_index.clamp(0, materials.albedo.shape[0] - 1).long()
    zero = torch.zeros((), device=radiance.device)
    emis = torch.where(hit[:, None], materials.emission[mesh], zero)
    miss_rad = torch.where(hit[:, None], zero, bg[None, :])
    radiance.index_add_(0, index, throughput * (emis + miss_rad))
    if last:
        return radiance

    normal = geometric_normal(hits, cur.direction)
    new_dir = cosine_sample(generator, normal, u1, u2)
    origin = hits.position() + epsilon * normal
    throughput = throughput * torch.where(hit[:, None],
                                          materials.albedo[mesh], zero)
    alive = hit & (throughput.amax(dim=1) > _MIN_THROUGHPUT)
    nxt = Rays(
        origin=origin, direction=new_dir,
        min_t=torch.full((cur.count,), epsilon, dtype=torch.float32,
                         device=origin.device),
        max_t=torch.where(alive, _LIVE_MAX_T, 0.0))
    # Dead rays to the back; optionally Morton-sorted within the live run.
    order_key = (~alive).to(torch.int32)
    if sort_rays:
        order_key = (order_key << 28) | (_ray_sort_key(nxt, lo, hi) >> 4)
    perm = torch.sort(order_key, stable=True).indices
    return radiance, nxt, throughput, perm, alive.sum()


class _View3(ctypes.Structure):
    """csrc/shade.cu's View3: an (n, 3) f32 view with element strides."""

    _fields_ = [("p", ctypes.c_void_p), ("s0", ctypes.c_longlong),
                ("s1", ctypes.c_longlong)]


class ShadeArgs(ctypes.Structure):
    """csrc/shade.cu's RtkShadeArgs, field for field."""

    _fields_ = ([("n", ctypes.c_longlong), ("rows", ctypes.c_longlong)]
                + [(f, ctypes.c_int) for f in ("packet", "last", "sort_rays",
                                               "materials")]
                + [(f, ctypes.c_void_p) for f in ("hit", "t", "slot", "u",
                                                  "v", "tri_v", "tri_mesh")]
                + [(f, _View3) for f in ("origin", "direction",
                                         "ray_direction")]
                + [(f, ctypes.c_void_p) for f in (
                    "throughput", "index", "radiance", "albedo", "emission",
                    "background", "lo", "hi", "draws")]
                + [("ds0", ctypes.c_longlong), ("ds1", ctypes.c_longlong),
                   ("draw_index", ctypes.c_void_p)]
                + [(f, ctypes.c_float) for f in ("epsilon", "min_throughput",
                                                 "live_max_t")]
                + [(f, ctypes.c_void_p) for f in (
                    "next_origin", "next_direction", "next_min_t",
                    "next_max_t", "next_throughput", "key", "alive",
                    "instance", "object_from_world")]
                + [("instances", ctypes.c_longlong)])


def _view3(a, what, n, dev):
    library.check_tensor(a, what, torch.float32, (n, 3), dev)
    return _View3(a.data_ptr(), *a.stride())


def _shade_args(hits, cur: Rays, throughput, index, radiance,
                materials: Materials, bg, lo, hi, *, epsilon, sort_rays,
                last, draws=None, draw_index=None):
    """Check the shade kernel's inputs (device, dtype, shape; radiance
    contiguous, as it is written in place), allocate its outputs with
    torch.empty on their device -> (ShadeArgs, outputs (None if last,
    else (next rays, throughput, key, number alive)), the contiguous
    copies the arguments point into, to be held until the launch).  The
    arguments of shade_kernel; every other tensor they point into is the
    caller's."""
    dev = radiance.device
    n = cur.count
    keep = []

    def ptr(a, what, dtype, shape):
        library.check_tensor(a, what, dtype, shape, dev)
        keep.append(a.contiguous())
        return keep[-1].data_ptr()

    if not radiance.is_contiguous():
        raise ValueError("radiance must be contiguous (it is updated in "
                         "place)")
    a = ShadeArgs(n=n, last=int(bool(last)), sort_rays=int(bool(sort_rays)),
                  epsilon=epsilon, min_throughput=_MIN_THROUGHPUT,
                  live_max_t=_LIVE_MAX_T)
    a.radiance = ptr(radiance, "radiance", torch.float32, (None, 3))
    a.hit = ptr(hits.hit, "hits.hit", torch.bool, (n,))
    a.throughput = ptr(throughput, "throughput", torch.float32, (n, 3))
    a.index = ptr(index, "index", torch.int64, (n,))
    m = materials.albedo.shape[0]
    if m < 1:
        raise ValueError("materials must hold at least one row")
    a.materials = m
    a.albedo = ptr(materials.albedo, "albedo", torch.float32, (m, 3))
    a.emission = ptr(materials.emission, "emission", torch.float32, (m, 3))
    a.background = ptr(bg, "background", torch.float32, (3,))
    a.lo = ptr(lo, "lo", torch.float32, (3,))
    a.hi = ptr(hi, "hi", torch.float32, (3,))
    if isinstance(hits, PacketHits):
        a.packet, a.rows = 1, hits.tri_mesh.shape[0]
        a.tri_v = ptr(hits.tri_v, "tri_v", torch.float32, (a.rows, 3, 3))
        a.tri_mesh = ptr(hits.tri_mesh, "tri_mesh", torch.int32, (a.rows,))
        a.slot = ptr(hits.slot, "hits.slot", torch.int32, (n,))
        a.t = ptr(hits.t, "hits.t", torch.float32, (n,))
        a.origin = _view3(hits.origin, "hits.origin", n, dev)
        a.direction = _view3(hits.direction, "hits.direction", n, dev)
        if hits.instance is not None:
            a.instances = hits.object_from_world.shape[0]
            a.instance = ptr(hits.instance, "hits.instance", torch.int32,
                             (n,))
            a.object_from_world = ptr(hits.object_from_world,
                                      "hits.object_from_world",
                                      torch.float32, (a.instances, 3, 4))
    else:
        a.packet, a.rows = 0, n
        a.tri_v = ptr(hits.vertex_position, "hits.vertex_position",
                      torch.float32, (n, 3, 3))
        a.tri_mesh = ptr(hits.mesh_index, "hits.mesh_index", torch.int32,
                         (n,))
        a.u = ptr(hits.u, "hits.u", torch.float32, (n,))
        a.v = ptr(hits.v, "hits.v", torch.float32, (n,))
    if last:
        return a, None, keep
    a.ray_direction = _view3(cur.direction, "rays.direction", n, dev)
    if draws is None or draws.dim() != 2 or draws.shape[1] != 2:
        raise ValueError("draws must be a (*, 2) tensor: u1, u2 a row")
    rows = n if draw_index is None else radiance.shape[0]
    library.check_tensor(draws, "draws", torch.float32, (rows, 2), dev)
    a.draws, a.ds0, a.ds1 = draws.data_ptr(), *draws.stride()
    if draw_index is not None:
        a.draw_index = ptr(draw_index, "draw_index", torch.int64, (n,))
    f32 = dict(dtype=torch.float32, device=dev)
    nxt = Rays(origin=torch.empty((n, 3), **f32),
               direction=torch.empty((n, 3), **f32),
               min_t=torch.empty((n,), **f32), max_t=torch.empty((n,), **f32))
    tp = torch.empty((n, 3), **f32)
    key = torch.empty((n,), dtype=torch.int32, device=dev)
    alive = torch.empty((), dtype=torch.int64, device=dev)
    a.next_origin, a.next_direction = (nxt.origin.data_ptr(),
                                       nxt.direction.data_ptr())
    a.next_min_t, a.next_max_t = nxt.min_t.data_ptr(), nxt.max_t.data_ptr()
    a.next_throughput, a.key, a.alive = (tp.data_ptr(), key.data_ptr(),
                                         alive.data_ptr())
    return a, (nxt, tp, key, alive), keep


def _shade_call(lib, args: ShadeArgs, stream) -> int:
    """rtk_shade of prepared arguments -> its error code."""
    return lib.rtk_shade(ctypes.addressof(args), stream)


def shade_kernel(hits, cur: Rays, throughput, index, radiance,
                 materials: Materials, bg, lo, hi, *, epsilon, sort_rays,
                 last, draws=None, draw_index=None):
    """One bounce's shade pass on the card: one launch of the library's
    rtk_shade (csrc/shade.cu), equal bit for bit to _shade_sample's
    radiance, next rays, throughput and live count, and to the order key
    its sort permutation sorts.

    hits: the bounce's PacketHits or plain Hits; cur: the rays it traced;
    throughput (N, 3), index (N,) int64 (distinct paths, rows of
    radiance), radiance (paths, 3), updated in place; bg, lo, hi (3,).
    draws: the two uniforms a row, (N, 2) read by slot (draw_index None)
    or (paths, 2) read at draw_index (N,) int64 (the uniforms handed in by
    ray); unused on the last bounce.  -> radiance if last, else
    (radiance, next rays, throughput, order key (N,) int32, number alive
    (a 0-d int64 tensor)).  Raises if the tensors are not on one card, of
    the wrong dtype or shape, or the launch fails."""
    global SHADE_LAUNCHES
    if not radiance.is_cuda:
        raise ValueError("shade_kernel takes CUDA tensors; the plain "
                         "version is _shade_sample")
    args, out, keep = _shade_args(
        hits, cur, throughput, index, radiance, materials, bg, lo, hi,
        epsilon=epsilon, sort_rays=sort_rays, last=last, draws=draws,
        draw_index=draw_index)
    library.launch(radiance.device, "rtk_shade", _shade_call,
                   library.load_kernel(), args)
    del keep
    SHADE_LAUNCHES += 1
    return radiance if last else (radiance, *out)


def _shade_plain(hits, cur: Rays, throughput, index, radiance,
                 materials: Materials, generator, bg, lo, hi, *, epsilon,
                 sort_rays, last, uniforms, bounce):
    """render_path's shade step through the plain pass (CPU tensors): the
    uniforms handed in gathered by path, then _shade_sample."""
    u1 = u2 = None
    if uniforms is not None and not last:
        u1, u2 = uniforms[bounce, index].unbind(dim=1)
    return _shade_sample(hits, cur, throughput, index, radiance, materials,
                         generator, bg, lo, hi, epsilon=epsilon,
                         sort_rays=sort_rays, last=last, u1=u1, u2=u2)


def _shade_card(hits, cur: Rays, throughput, index, radiance,
                materials: Materials, generator, bg, lo, hi, *, epsilon,
                sort_rays, last, uniforms, bounce):
    """render_path's shade step through the kernel (CUDA tensors), with
    _shade_plain's results: the kernel reads the uniforms handed in at
    uniforms[bounce, index], or the generator's (2, N) draw, made first as
    cosine_sample makes it; then the sort of its key."""
    draws = draw_index = None
    if not last and uniforms is not None:
        draws, draw_index = uniforms[bounce], index
    elif not last:
        draws = torch.rand((2, cur.count), generator=generator,
                           device=radiance.device, dtype=torch.float32).T
    out = shade_kernel(hits, cur, throughput, index, radiance, materials, bg,
                       lo, hi, epsilon=epsilon, sort_rays=sort_rays,
                       last=last, draws=draws, draw_index=draw_index)
    if last:
        return out
    radiance, nxt, throughput, key, n_alive = out
    return (radiance, nxt, throughput, torch.sort(key, stable=True).indices,
            n_alive)


def _compact_take(cur: Rays, throughput, index, perm, *, m):
    sel = perm[:m]
    return cur[sel], throughput[sel], index[sel]


def render_path(
    tracer: Tracer,
    rays: Rays,
    materials: Materials,
    generator: torch.Generator | None = None,
    bounces: int = 4,
    background: tuple = (0.0, 0.0, 0.0),
    epsilon: float = 1e-4,
    sort_rays: bool = True,
    compact: bool = True,
    bounce_tracer: Tracer | None = None,
    *,
    uniforms: torch.Tensor | None = None,
) -> torch.Tensor:
    """Path-trace a ray batch; returns (N, 3) linear radiance on the rays'
    device.

    Lambertian BRDF with cosine importance sampling; emission accumulated
    at every hit; constant background radiance on miss.  Each bounce is a
    trace, the shade / sample / sort pass and, with compact=True, a gather
    of the live prefix into a power-of-two bucket (one host sync a bounce:
    the live count; none with compact=False, where every bounce keeps the
    full batch with dead rays at max_t = 0).

    generator: a torch.Generator on the rays' device (None: torch's
    default) in place of rtk_tpu's JAX key; it draws one pair of uniforms
    a slot of each bounce batch.
    bounce_tracer: optional engine for the incoherent bounce batches
    (e.g. Tracer(scene, engine="march")); primaries always go through
    `tracer`.
    uniforms: the draws handed in, (>= bounces, N, 2) float32 on the rays'
    device: bounce k of the path that started as ray i samples its next
    direction from uniforms[k, i] (the generator is then not used), so
    the radiance is the same with compact and sort_rays on or off.
    """
    global PATH_TRACES, PATH_ROWS, PATH_SYNCS
    n = rays.count
    dev = rays.device
    if uniforms is not None and (
            uniforms.dim() != 3 or uniforms.shape[0] < bounces
            or uniforms.shape[1:] != (n, 2)
            or uniforms.dtype != torch.float32 or uniforms.device != dev):
        raise ValueError(
            f"uniforms must be a float32 (>= {bounces}, {n}, 2) tensor on "
            f"{dev}, not {uniforms.dtype} {tuple(uniforms.shape)} on "
            f"{uniforms.device}")
    with span("rtk.path.render"):
        radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
        index = torch.arange(n, device=dev)  # slot -> original ray id
        cur = rays
        bg = _f32(background, dev)
        lo = tracer.scene.bounds_min
        hi = tracer.scene.bounds_max
        shade = _shade_card if dev.type == "cuda" else _shade_plain

        for bounce in range(bounces + 1):
            # `coherent` is the reference engine's stepping hint for bounce
            # batches; Tracer.closest accepts and ignores it.
            src = tracer if (bounce == 0 or bounce_tracer is None) \
                else bounce_tracer
            with span("rtk.path.trace"):
                hits = src.closest(cur, coherent=(bounce == 0))
            PATH_TRACES += 1
            PATH_ROWS += cur.count
            last = bounce == bounces
            with span("rtk.path.shade"):
                out = shade(hits, cur, throughput, index, radiance,
                            materials, generator, bg, lo, hi,
                            epsilon=epsilon, sort_rays=sort_rays, last=last,
                            uniforms=uniforms, bounce=bounce)
            if last:
                break
            radiance, nxt, throughput, perm, n_alive_dev = out

            if compact:
                with span("rtk.path.compact"):
                    n_alive = int(n_alive_dev)  # one host sync per bounce
                    PATH_SYNCS += 1
                    if n_alive == 0:
                        break
                    m = min(cur.count, _round_up_bucket(n_alive, 1024))
                    cur, throughput, index = _compact_take(
                        nxt, throughput, index, perm, m=m)
            else:
                cur = nxt

        return radiance


def render_direct(
    tracer: Tracer,
    rays: Rays,
    materials: Materials,
    light_pos,
    light_color,
    generator: torch.Generator | None = None,
    epsilon: float = 1e-4,
) -> torch.Tensor:
    """One-bounce direct lighting with a point light and any-hit shadow
    rays (the "1-bounce diffuse" and "primary + shadow" configurations).
    (N, 3).  `generator` stands where the reference takes its unused key."""
    dev = rays.device
    hits = tracer.closest(rays)
    hit = hits.hit
    mesh = hits.mesh_index.clamp(0, materials.albedo.shape[0] - 1).long()
    normal = geometric_normal(hits, rays.direction)
    p = hits.position() + epsilon * normal
    lvec = _f32(light_pos, dev)[None, :] - p
    ldist = torch.linalg.vector_norm(lvec, dim=1)
    ldir = lvec / ldist[:, None].clamp_min(1e-20)
    ndotl = (normal * ldir).sum(dim=1).clamp_min(0.0)

    shadow = Rays(
        origin=p, direction=ldir,
        min_t=torch.full_like(ldist, epsilon),
        max_t=torch.where(hit, ldist * (1.0 - 1e-3), 0.0))
    occluded = tracer.any(shadow).hit
    direct = (materials.albedo[mesh] * _f32(light_color, dev)[None, :]
              * (ndotl * ~occluded / (ldist * ldist).clamp_min(1e-8))[:, None])
    return torch.where(hit[:, None], direct + materials.emission[mesh],
                       torch.zeros((), device=dev))


def render_ao(
    tracer: Tracer,
    rays: Rays,
    generator: torch.Generator | None = None,
    samples: int = 8,
    max_dist: float = 1.0,
    epsilon: float = 1e-4,
) -> torch.Tensor:
    """Ambient occlusion: fraction of unoccluded cosine samples. (N,)."""
    hits = tracer.closest(rays)
    normal = geometric_normal(hits, rays.direction)
    p = hits.position() + epsilon * normal
    n = rays.count
    occ = torch.zeros((n,), dtype=torch.float32, device=rays.device)
    min_t = torch.full((n,), epsilon, dtype=torch.float32,
                       device=rays.device)
    max_t = torch.where(hits.hit, float(max_dist), 0.0)
    for _ in range(samples):
        probe = Rays(origin=p, direction=cosine_sample(generator, normal),
                     min_t=min_t, max_t=max_t)
        occ = occ + tracer.any(probe, coherent=False).hit.to(torch.float32)
    return torch.where(hits.hit, 1.0 - occ / samples, 0.0)
