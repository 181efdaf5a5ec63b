"""A plain path tracer: the radiance that `models/path.py::render_path`
documents, computed path by path, for tests to hold the render loop to.

Plain PyTorch in float32 on the tensors' device; it imports nothing of the
port's engines or kernels.  Every live path is traced one bounce at a time
by brute force over a triangle soup, all rays against all triangles; there
is no compaction, no sort and no bucket.

The model (lambertian, one sample a pixel):
  * path i starts as ray i with throughput 1 and radiance 0;
  * at bounce k = 0 .. bounces its ray's closest hit is found (rtk's
    watertight test; of triangles at one t the lowest soup row).  A hit
    adds throughput x the emission of the triangle's material, a miss adds
    throughput x background and ends the path.  Bounce `bounces` ends
    every path;
  * after a hit at bounce k < bounces: n is the triangle's unit geometric
    normal, (v1 - v0) x (v2 - v0), turned to face the ray; the next
    direction is cosine-distributed about n from uniforms[k, i]: radius
    sqrt(u1) and angle 2 pi u2 in the tangent plane, height sqrt(1 - u1),
    the tangent frame the branchless one of Duff et al., "Building an
    Orthonormal Basis, Revisited" (JCGT 2017), with the sign of n.z taken
    as +1 at 0; the next ray starts at o + t d + epsilon n with min_t
    epsilon and max_t 3.4e38; throughput is multiplied by the material's
    albedo, and a path whose throughput is at most 1e-5 in every channel
    ends.

Departures from render_path, each far below a check's tolerance:
  * a path that the throughput floor ends adds nothing more here; in
    render_path it rides on in its batch, is traced with max_t 0 (a miss)
    and adds its throughput (at most 1e-5) x background once more;
  * the closest hit is this file's own brute force, whose arithmetic order
    differs from the traversal's in the last bits of t: a path whose hit
    lies within rounding of an edge may take the other triangle.
"""
from __future__ import annotations

import math

import torch

LIVE_MAX_T = 3.4e38  # a bounce ray's max_t
MIN_THROUGHPUT = 1e-5  # a path at or below it in every channel ends
RAY_BLOCK = 256  # rays a pass of the brute force
ELEMS = 1 << 22  # rays x triangles a pass (bounds the temporaries)


def _edge(ax, ay, bx, by):
    """a x b in shear space, in float32; exact zeros (rtk's ambiguous
    case) recomputed from float64 products and rounded back."""
    e = ax * by - ay * bx
    zero = e == 0
    if bool(zero.any()):
        e64 = (ax.double() * by.double() - ay.double() * bx.double()).float()
        e = torch.where(zero, e64, e)
    return e


def closest(soup: torch.Tensor, origin, direction, min_t, max_t):
    """The closest hit of each ray against every triangle of soup (T, 3, 3)
    -> (hit (N,) bool, t (N,) f32, row (N,) int64, -1 on a miss).

    rtk's watertight test (Woop, Benthin and Wald, JCGT 2013): the shear
    axis z is the first axis of the largest |direction| component, x and y
    follow it cyclically; a hit needs the three edge functions of one sign
    (zero allowed) and min_t < t < max_t."""
    n = origin.shape[0]
    dev = origin.device
    ad = direction.abs()
    big = ad.amax(dim=1, keepdim=True)
    kz = torch.where(ad[:, 0:1] == big, 0,
                     torch.where(ad[:, 1:2] == big, 1, 2))[:, 0]
    best_t = torch.full((n,), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    chunk = max(1, ELEMS // RAY_BLOCK)
    for z in range(3):
        order = [(z + 1) % 3, (z + 2) % 3, z]
        tris = soup[:, :, order]
        rows = (kz == z).nonzero()[:, 0]
        for r0 in range(0, rows.numel(), RAY_BLOCK):
            r = rows[r0:r0 + RAY_BLOCK]
            o = origin[r][:, order][:, None]
            d = direction[r][:, order]
            sx = (-d[:, 0] / d[:, 2])[:, None]
            sy = (-d[:, 1] / d[:, 2])[:, None]
            sz = (1.0 / d[:, 2])[:, None]
            lo, hi = min_t[r][:, None], max_t[r][:, None]
            for c0 in range(0, tris.shape[0], chunk):
                p = tris[None, c0:c0 + chunk] - o[:, :, None, :]
                x = p[..., 0] + sx[..., None] * p[..., 2]
                y = p[..., 1] + sy[..., None] * p[..., 2]
                zs = sz[..., None] * p[..., 2]
                u = _edge(x[..., 1], y[..., 1], x[..., 2], y[..., 2])
                v = _edge(x[..., 2], y[..., 2], x[..., 0], y[..., 0])
                w = _edge(x[..., 0], y[..., 0], x[..., 1], y[..., 1])
                neg = (u < 0) | (v < 0) | (w < 0)
                pos = (u > 0) | (v > 0) | (w > 0)
                det = u + v + w
                t = (u * zs[..., 0] + v * zs[..., 1] + w * zs[..., 2]) / det
                ok = ~(neg & pos) & (det != 0) & (t > lo) & (t < hi)
                t = torch.where(ok, t, math.inf)
                tmin, arg = t.min(dim=1)  # the first of equal minima
                better = tmin < best_t[r]
                best_t[r] = torch.where(better, tmin, best_t[r])
                best_i[r] = torch.where(better, arg + c0, best_i[r])
    return best_i >= 0, best_t, best_i


def _frame(n):
    """Two unit tangents completing n to an orthonormal frame (Duff et al.
    2017, sign of n.z +1 at 0)."""
    nx, ny, nz = n.unbind(dim=1)
    s = torch.where(nz >= 0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    return (torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=1),
            torch.stack([b, s + ny * ny * a, -ny], dim=1))


def render(soup, tri_material, albedo, emission, origin, direction, min_t,
           max_t, uniforms, bounces=4, background=(0.0, 0.0, 0.0),
           epsilon=1e-4):
    """Radiance (N, 3) f32 of N paths, the module's model.  soup (T, 3, 3);
    tri_material (T,) the material of each soup row; albedo, emission
    (M, 3); the primaries origin, direction (N, 3), min_t, max_t (N,);
    uniforms (>= bounces, N, 2) indexed by bounce and path."""
    dev = origin.device
    f32 = dict(dtype=torch.float32, device=dev)
    soup = soup.to(**f32)
    albedo, emission = albedo.to(**f32), emission.to(**f32)
    bg = torch.as_tensor(background, **f32)
    n = origin.shape[0]
    radiance = torch.zeros((n, 3), **f32)
    path = torch.arange(n, device=dev)  # the live paths
    thr = torch.ones((n, 3), **f32)
    o, d = origin.to(**f32), direction.to(**f32)
    lo, hi = min_t.to(**f32), max_t.to(**f32)
    for k in range(bounces + 1):
        hit, t, row = closest(soup, o, d, lo, hi)
        mat = tri_material[row.clamp_min(0)]
        radiance[path] += thr * torch.where(hit[:, None], emission[mat], bg)
        if k == bounces:
            break
        tri = soup[row[hit]]
        e = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        nrm = e / (e * e).sum(dim=1, keepdim=True).sqrt()
        dh, th = d[hit], t[hit]
        nrm = torch.where(((nrm * dh).sum(dim=1) > 0)[:, None], -nrm, nrm)
        u = uniforms[k, path[hit]].to(**f32)
        rad, phi = u[:, 0].sqrt(), 2.0 * math.pi * u[:, 1]
        t1, t2 = _frame(nrm)
        d = ((rad * phi.cos())[:, None] * t1 + (rad * phi.sin())[:, None] * t2
             + (1.0 - u[:, 0]).clamp_min(0.0).sqrt()[:, None] * nrm)
        o = o[hit] + th[:, None] * dh + epsilon * nrm
        thr = thr[hit] * albedo[mat[hit]]
        path = path[hit]
        on = thr.amax(dim=1) > MIN_THROUGHPUT
        path, thr, o, d = path[on], thr[on], o[on], d[on]
        lo = torch.full((path.numel(),), epsilon, **f32)
        hi = torch.full((path.numel(),), LIVE_MAX_T, **f32)
        if path.numel() == 0:
            break
    return radiance
