"""A plain instanced path tracer: the radiance that
`models/path.py::render_path` documents over an instanced scene
(`instancing.py::InstancedTracer`), path by path, for tests to hold the
instanced render loop to.

Plain PyTorch in float32 on the tensors' device; it imports nothing of the
port's engines or kernels, only testing/path_reference.py's brute force
and tangent frame.  The scene is one BLAS soup (T, 3, 3) in object space
and a (3, 4) world_from_object affine an instance.

The model is path_reference.py's, with the closest hit and the normal of
an instanced scene:
  * object_from_world of each instance is this file's own inverse of its
    affine: torch.linalg.inv of the linear part in float32, and the
    translation -(L t), each component a fixed sum of products;
  * the object ray of instance i: origin and direction each component a
    fixed sum of products of object_from_world with the world ray (the
    direction not normalised, so t is world t);
  * the closest hit of a ray over all instances: rtk's watertight test by
    brute force over the BLAS soup in each instance's object space; the
    nearest t wins, of equal t the lowest instance, then the lowest soup
    row;
  * the normal: (v1 - v0) x (v2 - v0) of the object-space triangle mapped
    to world space as L^T n (L the linear part of the hit instance's
    object_from_world), normalised and turned to face the ray; the next
    ray starts at the world hit point o + t d + epsilon n.

An instance is tested only against the rays whose segment [min_t, max_t]
meets its world box grown by MARGIN of the box's largest extent (a float64
slab test).  The box is the BLAS soup's bounds through the affine; a hit
lies inside it but for the rounding of the inverse, the object ray and the
test, a few float32 ulps of the coordinates, which MARGIN exceeds by
orders of magnitude, so the cull changes no answer.

Departures from render_path, besides path_reference.py's:
  * the inverse is this file's own: where an affine's inverse is not exact
    in float32 (a rotation, a scale not a power of two) its last bits may
    differ from build_instanced's (NumPy's), and so the object rays, t and
    the normal by a few ulps;
  * of equal t in two instances, render_path keeps the one its candidate
    rounds reach first (the nearer box entry), this file the lowest.
"""
from __future__ import annotations

import math

import torch

from rtk_tpu_torch.testing import path_reference

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
    extent -> (lo, hi), each (I, 3) float64."""
    s = torch.as_tensor(soup, dtype=torch.float64).reshape(-1, 3)
    lo, hi = s.amin(dim=0), s.amax(dim=0)
    bits = (torch.arange(8)[:, None] >> torch.arange(3)) & 1
    corners = torch.where(bits.bool(), hi, lo)  # (8, 3)
    tf = torch.as_tensor(transforms, dtype=torch.float64)
    world = (torch.einsum("iab,cb->ica", tf[:, :, :3], corners)
             + tf[:, None, :, 3])
    wlo, whi = world.amin(dim=1), world.amax(dim=1)
    grow = margin * (whi - wlo).amax(dim=1, keepdim=True)
    return wlo - grow, whi + grow


def overlap(lo, hi, origin, direction, min_t, max_t) -> torch.Tensor:
    """(N, I) bool: ray n's segment [min_t, max_t] meets box i (float64;
    a zero direction component needs the origin inside that slab)."""
    o = origin.double()[:, None]
    d = direction.double()[:, None]
    lo, hi = lo.to(o.device)[None], hi.to(o.device)[None]
    flat = d == 0
    safe = torch.where(flat, 1.0, d)
    t0, t1 = (lo - o) / safe, (hi - o) / safe
    inside = (o >= lo) & (o <= hi)
    near = torch.where(flat, torch.where(inside, -math.inf, math.inf),
                       torch.minimum(t0, t1))
    far = torch.where(flat, torch.where(inside, math.inf, -math.inf),
                      torch.maximum(t0, t1))
    enter = torch.maximum(near.amax(dim=2), min_t.double()[:, None])
    exit_ = torch.minimum(far.amin(dim=2), max_t.double()[:, None])
    return enter <= exit_


def object_rays(m, origin, direction):
    """World rays -> object rays of per-ray (N, 3, 4) affines m."""
    o = (m[:, :, 0] * origin[:, 0:1] + m[:, :, 1] * origin[:, 1:2]
         + m[:, :, 2] * origin[:, 2:3] + m[:, :, 3])
    d = (m[:, :, 0] * direction[:, 0:1] + m[:, :, 1] * direction[:, 1:2]
         + m[:, :, 2] * direction[:, 2:3])
    return o, d


def closest(soup, inverse, boxes, origin, direction, min_t, max_t):
    """The closest hit of each ray over every instance -> (hit (N,) bool,
    t (N,) f32 (inf on a miss), row (N,) int64 soup row, instance (N,)
    int64; -1 on a miss).  inverse: object_from_world (I, 3, 4); boxes:
    world_boxes."""
    n = origin.shape[0]
    dev = origin.device
    ray, inst = overlap(*boxes, origin, direction, min_t,
                        max_t).nonzero(as_tuple=True)  # by ray, instance
    o, d = object_rays(inverse.to(dev)[inst], origin[ray], direction[ray])
    hit, t, row = path_reference.closest(soup, o, d, min_t[ray], max_t[ray])
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


def world_normal(soup_rows, inverse_rows) -> torch.Tensor:
    """The unit world normal of object-space triangles (H, 3, 3) under the
    per-row (H, 3, 4) object_from_world, not yet turned to a ray."""
    e = torch.linalg.cross(soup_rows[:, 1] - soup_rows[:, 0],
                           soup_rows[:, 2] - soup_rows[:, 0])
    m = inverse_rows
    e = (m[:, 0, :3] * e[:, 0:1] + m[:, 1, :3] * e[:, 1:2]
         + m[:, 2, :3] * e[:, 2:3])
    return e / (e * e).sum(dim=1, keepdim=True).sqrt()


def render(soup, transforms, tri_material, albedo, emission, origin,
           direction, min_t, max_t, uniforms, bounces=4,
           background=(0.0, 0.0, 0.0), epsilon=1e-4):
    """Radiance (N, 3) f32 of N paths, the module's model.  soup (T, 3, 3)
    the BLAS in object space; transforms (I, 3, 4) world_from_object;
    tri_material (T,) the material of each soup row; albedo, emission
    (M, 3); the primaries origin, direction (N, 3), min_t, max_t (N,);
    uniforms (>= bounces, N, 2) indexed by bounce and path."""
    dev = origin.device
    f32 = dict(dtype=torch.float32, device=dev)
    soup = torch.as_tensor(soup).to(**f32)
    inverse = object_from_world(transforms).to(dev)
    boxes = world_boxes(soup.cpu(), transforms)
    albedo, emission = albedo.to(**f32), emission.to(**f32)
    bg = torch.as_tensor(background, **f32)
    n = origin.shape[0]
    radiance = torch.zeros((n, 3), **f32)
    path = torch.arange(n, device=dev)  # the live paths
    thr = torch.ones((n, 3), **f32)
    o, d = origin.to(**f32), direction.to(**f32)
    lo, hi = min_t.to(**f32), max_t.to(**f32)
    for k in range(bounces + 1):
        hit, t, row, inst = closest(soup, inverse, boxes, o, d, lo, hi)
        mat = tri_material[row.clamp_min(0)]
        radiance[path] += thr * torch.where(hit[:, None], emission[mat], bg)
        if k == bounces:
            break
        nrm = world_normal(soup[row[hit]], inverse[inst[hit]])
        dh, th = d[hit], t[hit]
        nrm = torch.where(((nrm * dh).sum(dim=1) > 0)[:, None], -nrm, nrm)
        u = uniforms[k, path[hit]].to(**f32)
        rad, phi = u[:, 0].sqrt(), 2.0 * math.pi * u[:, 1]
        t1, t2 = path_reference._frame(nrm)
        d = ((rad * phi.cos())[:, None] * t1 + (rad * phi.sin())[:, None] * t2
             + (1.0 - u[:, 0]).clamp_min(0.0).sqrt()[:, None] * nrm)
        o = o[hit] + th[:, None] * dh + epsilon * nrm
        thr = thr[hit] * albedo[mat[hit]]
        path = path[hit]
        on = thr.amax(dim=1) > path_reference.MIN_THROUGHPUT
        path, thr, o, d = path[on], thr[on], o[on], d[on]
        lo = torch.full((path.numel(),), epsilon, **f32)
        hi = torch.full((path.numel(),), path_reference.LIVE_MAX_T, **f32)
        if path.numel() == 0:
            break
    return radiance
