"""The plain instanced path tracer: the radiance of the `instanced_path`
query, path by path.

The scene is one BLAS soup (T, 3, 3) in object space and a (3, 4)
world_from_object affine an instance, from the scene generator.  The model
is path_reference.py's (lambertian, one sample a pixel, the uniforms by
path and bounce, the throughput floor), with the closest hit and the
normal of an instanced scene:
  * object_from_world of each instance is this file's own inverse of its
    affine: torch.linalg.inv of the linear part in float32, and the
    translation -(L t), each component a fixed sum of products;
  * the object ray of instance i: origin and direction each component a
    fixed sum of products of object_from_world with the world ray (the
    direction not normalised, so t is world t);
  * the closest hit of a ray over all instances: reference.closest (rtk's
    watertight test by brute force) over the BLAS soup in each instance's
    object space; the nearest t wins, of equal t the lowest instance, then
    the lowest soup row;
  * after a hit: n = (v1 - v0) x (v2 - v0) of the object-space triangle,
    mapped to world space as L^T n (L the linear part of the hit
    instance's object_from_world), normalised and turned to face the ray;
    the next ray starts at the world hit point o + t d + epsilon n with
    min_t epsilon and max_t 3.4e38.

An instance is tested only against the rays whose segment [min_t, max_t]
meets its world box grown by MARGIN of the box's largest extent (a float64
slab test).  The box is the BLAS soup's bounds through the affine; a hit
lies inside it but for the rounding of the inverse, the object ray and the
test, a few float32 ulps of the coordinates, which MARGIN exceeds by
orders of magnitude, so the cull changes no answer.

Every live path is traced each bounce: no compaction, no sort, no bucket.
Where render_path departs from it, by less than the check's tolerance: a
path the throughput floor ends rides on in render_path's batch and adds
its throughput (at most 1e-5) x background once more; of equal t in two
instances render_path keeps the one its candidate rounds reach first (the
nearer box entry), this file the lowest.

It imports only torch and the benchmark's reference, and reads nothing the
program made: the BLAS and the affines come from the scene generator, the
rays and the uniforms from the traffic generator.  `dtype` computes the
rays, the test and the shading in a lower precision (the control).
"""
from __future__ import annotations

import math

import torch

from rtbench import reference

LIVE_MAX_T = 3.4e38
MIN_THROUGHPUT = 1e-5
MARGIN = 1e-3  # the cull's growth of a world box, a share of its extent


def object_from_world(transforms) -> torch.Tensor:
    """(I, 3, 4) world_from_object affines -> (I, 3, 4) f32 inverses."""
    tf = torch.as_tensor(transforms, dtype=torch.float32)
    lin = torch.linalg.inv(tf[:, :, :3])
    t = tf[:, :, 3]
    move = -(lin[:, :, 0] * t[:, 0:1] + lin[:, :, 1] * t[:, 1:2]
             + lin[:, :, 2] * t[:, 2:3])
    return torch.cat([lin, move[:, :, None]], dim=2)


def world_boxes(soup, transforms, margin: float = MARGIN):
    """The instances' world boxes, each grown by `margin` of its largest
    extent -> (lo, hi), each (I, 3) float64 on the soup's device."""
    s = torch.as_tensor(soup).to(torch.float64).reshape(-1, 3)
    lo, hi = s.amin(dim=0), s.amax(dim=0)
    bits = ((torch.arange(8, device=s.device)[:, None]
             >> torch.arange(3, device=s.device)) & 1).bool()
    corners = torch.where(bits, hi, lo)  # (8, 3)
    tf = torch.as_tensor(transforms).to(s.device, torch.float64)
    world = (torch.einsum("iab,cb->ica", tf[:, :, :3], corners)
             + tf[:, None, :, 3])
    wlo, whi = world.amin(dim=1), world.amax(dim=1)
    grow = margin * (whi - wlo).amax(dim=1, keepdim=True)
    return wlo - grow, whi + grow


def overlap(lo, hi, origin, direction, min_t, max_t) -> torch.Tensor:
    """(N, I) bool: ray n's segment [min_t, max_t] meets box i (float64;
    a zero direction component needs the origin inside that slab)."""
    o = origin.to(torch.float64)[:, None]
    d = direction.to(torch.float64)[:, None]
    lo, hi = lo[None], hi[None]
    flat = d == 0
    safe = torch.where(flat, 1.0, d)
    t0, t1 = (lo - o) / safe, (hi - o) / safe
    inside = (o >= lo) & (o <= hi)
    near = torch.where(flat, torch.where(inside, -math.inf, math.inf),
                       torch.minimum(t0, t1))
    far = torch.where(flat, torch.where(inside, math.inf, -math.inf),
                      torch.maximum(t0, t1))
    enter = torch.maximum(near.amax(dim=2), min_t.to(torch.float64)[:, None])
    exit_ = torch.minimum(far.amin(dim=2), max_t.to(torch.float64)[:, None])
    return enter <= exit_


def object_rays(m, origin, direction):
    """World rays -> object rays of per-ray (N, 3, 4) affines m."""
    o = (m[:, :, 0] * origin[:, 0:1] + m[:, :, 1] * origin[:, 1:2]
         + m[:, :, 2] * origin[:, 2:3] + m[:, :, 3])
    d = (m[:, :, 0] * direction[:, 0:1] + m[:, :, 1] * direction[:, 1:2]
         + m[:, :, 2] * direction[:, 2:3])
    return o, d


def closest(soup, inverse, boxes, origin, direction, min_t, max_t,
            dtype=torch.float32):
    """The closest hit of each ray over every instance -> (hit (N,) bool,
    t (N,) f32 (inf on a miss), row (N,) int64 soup row, instance (N,)
    int64; -1 on a miss).  inverse: object_from_world (I, 3, 4) on the
    rays' device; boxes: world_boxes."""
    n = origin.shape[0]
    dev = origin.device
    ray, inst = overlap(*boxes, origin, direction, min_t,
                        max_t).nonzero(as_tuple=True)  # by ray, instance
    o, d = object_rays(inverse[inst].to(dtype), origin[ray].to(dtype),
                       direction[ray].to(dtype))
    hit, t, _, _, row = reference.closest(soup, o, d, min_t[ray], max_t[ray],
                                          dtype=dtype)
    t = torch.where(hit, t, math.inf)
    best_t = torch.full((n,), math.inf, device=dev).scatter_reduce(
        0, ray, t, "amin")
    win = hit & (t == best_t[ray])
    pairs = ray.numel()
    first = torch.full((n,), pairs, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(
        0, ray[win], torch.arange(pairs, device=dev)[win], "amin")
    found = first < pairs
    none = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if not pairs:
        return found, best_t, none, none
    pick = first.clamp(max=pairs - 1)
    return (found, best_t, torch.where(found, row[pick], none),
            torch.where(found, inst[pick], none))


def _frame(n):
    nx, ny, nz = n.unbind(dim=1)
    s = torch.where(nz >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    return (torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=1),
            torch.stack([b, s + ny * ny * a, -ny], dim=1))


def render(soup, transforms, albedo, emission, origin, direction, min_t,
           max_t, uniforms, bounces, background, epsilon,
           dtype=torch.float32):
    """Radiance (N, 3) f32 of N paths.  soup (T, 3, 3) the BLAS in object
    space on the rays' device; transforms (I, 3, 4) world_from_object; one
    material, albedo and emission (3,); the primaries' origin, direction
    (N, 3), min_t, max_t (N,); uniforms (>= bounces, N, 2)."""
    dev = origin.device
    cast = dict(dtype=dtype, device=dev)
    inverse = object_from_world(transforms).to(dev)
    boxes = world_boxes(soup, transforms)
    albedo = torch.as_tensor(albedo, **cast)
    emission = torch.as_tensor(emission, **cast)
    bg = torch.as_tensor(background, **cast)
    n = origin.shape[0]
    radiance = torch.zeros((n, 3), **cast)
    path = torch.arange(n, device=dev)
    thr = torch.ones((n, 3), **cast)
    o, d = origin.to(dtype), direction.to(dtype)
    lo, hi = min_t, max_t
    for k in range(bounces + 1):
        hit, t, row, inst = closest(soup, inverse, boxes, o, d, lo, hi,
                                    dtype=dtype)
        radiance[path] += thr * torch.where(hit[:, None], emission, bg)
        if k == bounces:
            break
        tri = soup[row[hit]].to(dtype)
        e = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        m = inverse[inst[hit]].to(dtype)
        e = (m[:, 0, :3] * e[:, 0:1] + m[:, 1, :3] * e[:, 1:2]
             + m[:, 2, :3] * e[:, 2:3])
        nrm = e / (e * e).sum(dim=1, keepdim=True).sqrt()
        dh, th = d[hit], t[hit].to(dtype)
        nrm = torch.where(((nrm * dh).sum(dim=1) > 0)[:, None], -nrm, nrm)
        u = uniforms[k, path[hit]].to(dtype)
        r, phi = u[:, 0].sqrt(), 2.0 * math.pi * u[:, 1]
        t1, t2 = _frame(nrm)
        d = ((r * phi.cos())[:, None] * t1 + (r * phi.sin())[:, None] * t2
             + (1.0 - u[:, 0]).clamp_min(0.0).sqrt()[:, None] * nrm)
        o = o[hit] + th[:, None] * dh + epsilon * nrm
        thr = thr[hit] * albedo
        path = path[hit]
        on = thr.amax(dim=1) > MIN_THROUGHPUT
        path, thr, o, d = path[on], thr[on], o[on], d[on]
        if path.numel() == 0:
            break
        lo = torch.full((path.numel(),), epsilon, dtype=torch.float32,
                        device=dev)
        hi = torch.full_like(lo, LIVE_MAX_T)
    return radiance.float()
