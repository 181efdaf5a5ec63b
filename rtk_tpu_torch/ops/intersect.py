"""Watertight ray/triangle intersection and ray/AABB slab tests (batched).

Semantics follow rtk (and rtk_tpu/ops/intersect.py) exactly:
  * shear basis: z = first axis attaining max |dir| component (x, then y,
    then z priority), x/y cyclic (rtk.c:550-556);
  * shear constants -dx/dz, -dy/dz, 1/dz with exact division (rtk.c:561-563);
  * 2D shear-space edge functions u, v, w; a hit requires all three to share
    a sign (zero allowed on either side), rtk.c:298-344;
  * exact-zero edge functions are recomputed in float64 and rounded to
    float32, as rtk does (rtk.c:294-336): the products of two f32 values
    are exact in f64, so the sign of the difference is exact;
  * t = (u*z0 + v*z1 + w*z2) / det, accepted iff min_t < t < cur_t;
  * returned u, v are u/det, v/det: barycentric weights of vertices 0 and 1.

Every product and sum is a separate rounding (eager PyTorch never fuses
a*b+c), which is what keeps shared-edge functions exact negations.  The
CUDA kernel (csrc/packet_trace.cu) is built with -fmad=false for the same
reason, so the two agree bit for bit.

All functions broadcast over arbitrary leading batch dimensions.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ShearBasis:
    """Per-ray shear-space basis (parity: _rtk_trace setup, rtk.c:550-567)."""

    kx: torch.Tensor  # (...,) i64 axis indices
    ky: torch.Tensor
    kz: torch.Tensor
    sx: torch.Tensor  # (...,) f32 shear constants
    sy: torch.Tensor
    sz: torch.Tensor


def ray_shear(direction: torch.Tensor) -> ShearBasis:
    """Compute the shear basis for each ray direction (..., 3)."""
    d = direction.to(torch.float32)
    ad = d.abs()
    maxc = ad.amax(dim=-1)
    # First axis attaining the max: x, then y, then z (rtk.c:553).
    kz = torch.where(ad[..., 0] == maxc, 0,
                     torch.where(ad[..., 1] == maxc, 1, 2)).long()
    kx = (kz + 1) % 3
    ky = (kz + 2) % 3

    def take(idx):
        return torch.gather(d, -1, idx[..., None])[..., 0]

    dx, dy, dz = take(kx), take(ky), take(kz)
    return ShearBasis(kx=kx, ky=ky, kz=kz, sx=-dx / dz, sy=-dy / dz,
                      sz=1.0 / dz)


def _edge_f64(ax, ay, bx, by):
    """ax*by - ay*bx in float64, rounded to float32 (rtk.c:306-336)."""
    return (ax.double() * by.double() - ay.double() * bx.double()).float()


def watertight_uvw(x0, y0, x1, y1, x2, y2, watertight: bool = True):
    """Shear-space edge functions with exact-zero fix-up (rtk.c:298-336)."""
    u = x1 * y2 - y1 * x2
    v = x2 * y0 - y2 * x0
    w = x0 * y1 - y0 * x1
    if watertight:
        need = (u == 0.0) | (v == 0.0) | (w == 0.0)
        if bool(need.any()):
            u = torch.where(need, _edge_f64(x1, y1, x2, y2), u)
            v = torch.where(need, _edge_f64(x2, y2, x0, y0), v)
            w = torch.where(need, _edge_f64(x0, y0, x1, y1), w)
    return u, v, w


def intersect_triangles(origin, shear: ShearBasis, tri_v, min_t, cur_t,
                        watertight: bool = True):
    """Intersect each ray against K triangles.

    Args:
      origin: (..., 3) ray origins.
      shear: per-ray ShearBasis with (...,) fields.
      tri_v: (..., K, 3, 3) triangle vertices [tri, vertex, xyz].
      min_t: (...,) ray minimum t.
      cur_t: (...,) current closest hit t (exclusive upper bound).

    Returns:
      (t, u, v, valid): each (..., K); u, v already divided by det.
      Invalid lanes have valid=False (their t may be inf/NaN).
    """
    rel = tri_v - origin[..., None, None, :]  # (..., K, 3, 3)

    def take(idx):
        idx = idx[..., None, None, None].expand(rel.shape[:-1] + (1,))
        return torch.gather(rel, -1, idx)[..., 0]

    vx, vy, vz = take(shear.kx), take(shear.ky), take(shear.kz)  # (..., K, 3)
    x = vx + shear.sx[..., None, None] * vz
    y = vy + shear.sy[..., None, None] * vz
    z = shear.sz[..., None, None] * vz
    u, v, w = watertight_uvw(x[..., 0], y[..., 0], x[..., 1], y[..., 1],
                             x[..., 2], y[..., 2], watertight=watertight)
    # All of u, v, w must share a sign (zero allowed), rtk.c:338-344.
    lo = torch.minimum(torch.minimum(u, v), w)
    hi = torch.maximum(torch.maximum(u, v), w)
    bad_sign = (lo < 0.0) & (hi > 0.0)
    det = u + v + w
    rcp_det = 1.0 / det
    t = (u * z[..., 0] + v * z[..., 1] + w * z[..., 2]) * rcp_det
    # Open t interval, strict compares (rtk.c:354). NaN t fails both.
    valid = (t > min_t[..., None]) & (t < cur_t[..., None]) & ~bad_sign
    return t, u * rcp_det, v * rcp_det, valid


def slab_test(child_min, child_max, origin, rcp_dir, min_t, cur_t):
    """Ray vs W child AABBs, folded condition (rtk.c:449-473).

    Args:
      child_min/child_max: (..., W, 3).
      origin/rcp_dir: (..., 3).
      min_t/cur_t: (...,).

    Returns:
      (enter_t, hit): each (..., W); enter_t is max(near, min_t) for hit
      children and +inf for missed ones (rtk.c:470-471 blends inf).
    """
    o = origin[..., None, :]
    r = rcp_dir[..., None, :]
    # Near/far planes by direction sign (rtk.c:458-463); a 0*inf NaN lands
    # where the NaN-suppressing fold discards it.
    pos = r >= 0
    near = (torch.where(pos, child_min, child_max) - o) * r
    far = (torch.where(pos, child_max, child_min) - o) * r
    enter = torch.fmax(torch.fmax(near[..., 0], near[..., 1]),
                       torch.fmax(near[..., 2], min_t[..., None]))
    exit_ = torch.fmin(torch.fmin(far[..., 0], far[..., 1]),
                       torch.fmin(far[..., 2], cur_t[..., None]))
    hit = enter <= exit_
    return torch.where(hit, enter, torch.full_like(enter, float("inf"))), hit


def rcp_direction(direction: torch.Tensor) -> torch.Tensor:
    """Exact 1/dir (rtk.c:410, RTK_MM_RCP is a divide). 0 -> signed inf."""
    return 1.0 / direction.to(torch.float32)
