"""The plain path tracer: the radiance of the `path` query, path by path.

The model is the one rtk_tpu_torch's render_path documents (lambertian,
one sample a pixel), over the configuration's materials, consecutive
ranges of the soup's rows:
  * path i starts as ray i with throughput 1 and radiance 0;
  * at bounce k = 0 .. bounces its ray's closest hit is found
    (reference.closest: rtk's watertight test by brute force, the lowest
    soup row at one t).  A hit adds throughput x its material's emission;
    a miss adds throughput x background and ends the path.  Bounce
    `bounces` ends every path;
  * after a hit at bounce k < bounces: n is the triangle's unit geometric
    normal, (v1 - v0) x (v2 - v0), turned to face the ray; the next
    direction is cosine-distributed about n from uniforms[k, i]: radius
    sqrt(u1) and angle 2 pi u2 in the tangent plane, height sqrt(1 - u1),
    in the branchless tangent frame of Duff et al., "Building an
    Orthonormal Basis, Revisited" (JCGT 2017), the sign of n.z +1 at 0;
    the next ray starts at o + t d + epsilon n with min_t epsilon and
    max_t 3.4e38; throughput is multiplied by the material's albedo, and
    a path at most 1e-5 in every channel ends.

Every live path is traced each bounce: no compaction, no sort, no bucket.
Where render_path departs from it, by less than the check's tolerance:
a path the throughput floor ends rides on in render_path's batch and adds
its throughput (at most 1e-5) x background once more.

It imports only torch and the benchmark's reference, and reads nothing the
program made: the soup comes from the scene generator, the rays and the
uniforms from the traffic generator.  `dtype` computes the whole path in a
lower precision (the control).
"""
from __future__ import annotations

import math

import torch

from rtbench import reference

LIVE_MAX_T = 3.4e38
MIN_THROUGHPUT = 1e-5


def material_of_rows(rows, device) -> torch.Tensor:
    """(T,) int64 material of each soup row from the ranges' row counts."""
    return torch.repeat_interleave(torch.arange(len(rows), device=device),
                                   torch.as_tensor(rows, device=device))


def _frame(n):
    nx, ny, nz = n.unbind(dim=1)
    s = torch.where(nz >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    return (torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=1),
            torch.stack([b, s + ny * ny * a, -ny], dim=1))


def render(soup, material, albedo, emission, origin, direction, min_t,
           max_t, uniforms, bounces, background, epsilon,
           dtype=torch.float32):
    """Radiance (N, 3) f32 of N paths.  soup (T, 3, 3); material (T,) the
    material of each row; albedo, emission (M, 3); the primaries' origin,
    direction (N, 3), min_t, max_t (N,); uniforms (>= bounces, N, 2)."""
    dev = origin.device
    cast = dict(dtype=dtype, device=dev)
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
        hit, t, _, _, row = reference.closest(soup, o, d, lo, hi,
                                              dtype=dtype)
        mat = material[row.clamp_min(0)]
        radiance[path] += thr * torch.where(hit[:, None], emission[mat], bg)
        if k == bounces:
            break
        tri = soup[row[hit]].to(dtype)
        e = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        nrm = e / (e * e).sum(dim=1, keepdim=True).sqrt()
        dh, th = d[hit], t[hit].to(dtype)
        nrm = torch.where(((nrm * dh).sum(dim=1) > 0)[:, None], -nrm, nrm)
        u = uniforms[k, path[hit]].to(dtype)
        r, phi = u[:, 0].sqrt(), 2.0 * math.pi * u[:, 1]
        t1, t2 = _frame(nrm)
        d = ((r * phi.cos())[:, None] * t1 + (r * phi.sin())[:, None] * t2
             + (1.0 - u[:, 0]).clamp_min(0.0).sqrt()[:, None] * nrm)
        o = o[hit] + th[:, None] * dh + epsilon * nrm
        thr = thr[hit] * albedo[mat[hit]]
        path = path[hit]
        on = thr.amax(dim=1) > MIN_THROUGHPUT
        path, thr, o, d = path[on], thr[on], o[on], d[on]
        if path.numel() == 0:
            break
        lo = torch.full((path.numel(),), epsilon, dtype=torch.float32,
                        device=dev)
        hi = torch.full_like(lo, LIVE_MAX_T)
    return radiance.float()
