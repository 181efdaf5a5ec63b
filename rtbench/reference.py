"""The plain reference: watertight closest-hit ray queries by brute force.

Every ray is tested against every triangle of the soup with rtk's
watertight test (Woop, Benthin and Wald, "Watertight Ray/Triangle
Intersection", JCGT 2013, as rtk.c states it):

  * the shear axis z is the first axis attaining the largest |direction|
    component (x, then y, then z), x and y follow it cyclically;
  * shear constants sx = -dx/dz, sy = -dy/dz, sz = 1/dz;
  * edge functions u = x1*y2 - y1*x2, v = x2*y0 - y2*x0,
    w = x0*y1 - y0*x1 in shear space; where one is exactly zero all three
    are recomputed in float64 (the products of two float32 values are
    exact there) and rounded back;
  * a hit needs u, v, w of one sign (zero allowed), t = (u*z0 + v*z1 +
    w*z2) * (1/det) with det = u + v + w, and min_t < t < max_t;
  * the record is t, u/det (the weight of vertex 0), v/det (vertex 1) and
    the soup index of the nearest triangle; of triangles at one t the
    lowest index.

It imports only torch and numpy, and reads nothing the program made: the
soup comes from the scene generator, the rays from the traffic generator.
`dtype` computes the whole test in a lower precision (the control).
"""
from __future__ import annotations

import torch

RAY_BLOCK = 256  # rays a pass
ELEMS = 1 << 24  # rays x triangles a pass (bounds the temporaries)


def shear_axes(direction: torch.Tensor) -> torch.Tensor:
    """(N, 3) directions -> (N, 3) int64 axis order (kx, ky, kz)."""
    ad = direction.abs()
    m = ad.amax(dim=1)
    kz = torch.where(ad[:, 0] == m, 0, torch.where(ad[:, 1] == m, 1, 2))
    return torch.stack([(kz + 1) % 3, (kz + 2) % 3, kz], dim=1)


def _edge64(ax, ay, bx, by, dtype):
    return (ax.double() * by.double() - ay.double() * bx.double()).to(dtype)


def _test(o, d, tri, min_t, max_t, dtype):
    """The test in shear order.  o, d: (R, 3), their axes already in the
    order (kx, ky, kz); tri: in the same order, (R, 3, 3) for ray k against
    triangle k -> (hit, t, u, v), each (R,); or (1 or R, K, 3, 3) for each
    ray against K triangles -> each (R, K)."""
    o, d, tri = o.to(dtype), d.to(dtype), tri.to(dtype)
    lo_t, hi_t = min_t.to(dtype), max_t.to(dtype)
    sx = -d[:, 0] / d[:, 2]
    sy = -d[:, 1] / d[:, 2]
    sz = 1.0 / d[:, 2]
    if tri.dim() == 4:
        o, sx, sy, sz = o[:, None], sx[:, None], sy[:, None], sz[:, None]
        lo_t, hi_t = lo_t[:, None], hi_t[:, None]
    xs, ys, zs = [], [], []
    for j in range(3):
        rx = tri[..., j, 0] - o[..., 0]
        ry = tri[..., j, 1] - o[..., 1]
        rz = tri[..., j, 2] - o[..., 2]
        xs.append(rx + sx * rz)
        ys.append(ry + sy * rz)
        zs.append(sz * rz)
    (x0, x1, x2), (y0, y1, y2) = xs, ys
    u = x1 * y2 - y1 * x2
    v = x2 * y0 - y2 * x0
    w = x0 * y1 - y0 * x1
    zero = (u == 0) | (v == 0) | (w == 0)
    if bool(zero.any()):
        u = torch.where(zero, _edge64(x1, y1, x2, y2, dtype), u)
        v = torch.where(zero, _edge64(x2, y2, x0, y0, dtype), v)
        w = torch.where(zero, _edge64(x0, y0, x1, y1, dtype), w)
    mixed = ((u < 0) | (v < 0) | (w < 0)) & ((u > 0) | (v > 0) | (w > 0))
    rcp = 1.0 / (u + v + w)
    t = (u * zs[0] + v * zs[1] + w * zs[2]) * rcp
    hit = ~mixed & (t > lo_t) & (t < hi_t)
    return hit, t.float(), (u * rcp).float(), (v * rcp).float()


def closest(soup: torch.Tensor, origin, direction, min_t, max_t,
            dtype=torch.float32):
    """Closest hit of every ray against every triangle of `soup` (T, 3, 3)
    -> (hit (N,) bool, t (N,) f32 (max_t on a miss), u, v (N,) f32 (0 on a
    miss), index (N,) int64 (-1 on a miss)).  Runs on the tensors' device
    in blocks of RAY_BLOCK rays by ELEMS // RAY_BLOCK triangles."""
    n = origin.shape[0]
    dev = origin.device
    axes = shear_axes(direction)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    t_out = max_t.to(torch.float32).clone()
    u_out = torch.zeros(n, dtype=torch.float32, device=dev)
    v_out = torch.zeros(n, dtype=torch.float32, device=dev)
    idx_out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    tri_chunk = max(1, ELEMS // RAY_BLOCK)
    for kz in range(3):
        rows = (axes[:, 2] == kz).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        perm = [(kz + 1) % 3, (kz + 2) % 3, kz]
        tris = soup[:, :, perm]
        for r0 in range(0, rows.numel(), RAY_BLOCK):
            r = rows[r0:r0 + RAY_BLOCK]
            o, d = origin[r][:, perm], direction[r][:, perm]
            lo, hi = min_t[r], max_t[r]
            best_t = hi.to(torch.float32).clone()
            best_i = torch.full((r.numel(),), -1, dtype=torch.int64,
                                device=dev)
            best_u = torch.zeros(r.numel(), dtype=torch.float32, device=dev)
            best_v = torch.zeros_like(best_u)
            for c0 in range(0, tris.shape[0], tri_chunk):
                h, t, u, v = _test(o, d, tris[None, c0:c0 + tri_chunk], lo,
                                   hi, dtype)
                t = torch.where(h, t, torch.full_like(t, float("inf")))
                tmin, arg = t.min(dim=1)
                better = tmin < best_t
                sel = arg[:, None]
                best_t = torch.where(better, tmin, best_t)
                best_i = torch.where(better, arg + c0, best_i)
                best_u = torch.where(better, u.gather(1, sel)[:, 0], best_u)
                best_v = torch.where(better, v.gather(1, sel)[:, 0], best_v)
            found = best_i >= 0
            hit[r] = found
            t_out[r] = torch.where(found, best_t, hi.to(torch.float32))
            u_out[r], v_out[r], idx_out[r] = best_u, best_v, best_i
    return hit, t_out, u_out, v_out, idx_out


def pairs(tri: torch.Tensor, origin, direction, min_t, max_t,
          dtype=torch.float32):
    """The test of ray k against triangle tri[k] alone ((N, 3, 3)) ->
    (hit, t, u, v), each (N,)."""
    return tuple(a[:, 0] for a in per_ray(tri[:, None], origin, direction,
                                          min_t, max_t, dtype))


def per_ray(tri: torch.Tensor, origin, direction, min_t, max_t,
            dtype=torch.float32):
    """Each ray against its own K triangles, tri (N, K, 3, 3) -> (hit, t,
    u, v), each (N, K)."""
    axes = shear_axes(direction)
    o = origin.gather(1, axes)
    d = direction.gather(1, axes)
    idx = axes[:, None, None, :].expand(tri.shape)
    return _test(o, d, tri.gather(3, idx), min_t, max_t, dtype)
