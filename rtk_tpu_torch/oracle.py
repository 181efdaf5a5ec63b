"""Brute-force reference tracer: the semantic anchor for tests.

An independent math path from the production tracer: classic
Möller-Trumbore in float64 (the production path is Woop-style shear-space
edge functions in f32, rtk.c:181-388).  Two independent derivations
agreeing within tolerance is the test strategy; the C++ oracle
(utils/native_sah.py) is a third.

Runs in NumPy float64 on the host whatever device the rays are on;
O(rays x triangles), chunked over triangles and over rays.
"""
from __future__ import annotations

import numpy as np
import torch

from rtk_tpu_torch.types import Hits, Rays

_RAY_BLOCK = 512  # rays per pass: bounds the (rays, chunk, 3) f64 temporaries


def _cross(a, b):
    return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], axis=-1)


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _mt_intersect_f64(origin, direction, v0, v1, v2, min_t, max_t):
    """Möller-Trumbore, inclusive edges (watertight-equivalent zeros
    allowed).

    Returns (t, u, v, valid) with rtk's barycentric convention: u weights
    vertex 0, v weights vertex 1.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    p = _cross(direction, e2)
    det = _dot(e1, p)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        inv = 1.0 / det
        tvec = origin - v0
        q = _cross(tvec, e1)
        a = _dot(tvec, p) * inv  # weight of vertex 1
        b = _dot(direction, q) * inv  # weight of vertex 2
        t = _dot(e2, q) * inv
        valid = ((det != 0.0) & (a >= 0.0) & (b >= 0.0) & (a + b <= 1.0)
                 & (t > min_t) & (t < max_t))
        return t, 1.0 - a - b, a, valid


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def trace_brute(tri_pos, rays: Rays, tri_mesh=None, tri_prim=None,
                tri_vidx=None, chunk: int = 4096,
                anyhit: bool = False) -> Hits:
    """Closest-hit trace of every ray against every triangle -> Hits of
    CPU tensors.

    Args:
      tri_pos: (T, 3, 3) triangle vertices.
      rays: batch of N rays (tensors on any device).
      tri_mesh/tri_prim/tri_vidx: optional per-triangle metadata; default
        mesh 0, prim = array index, vidx = 3i+corner.
      anyhit: accepted as the reference accepts it, and as there without
        effect: the nearest hit answers an any-hit query too.
    """
    tri_pos = _f64(tri_pos)
    t_count = tri_pos.shape[0]
    if tri_mesh is None:
        tri_mesh = np.zeros((t_count,), np.int32)
    if tri_prim is None:
        tri_prim = np.arange(t_count, dtype=np.int32)
    if tri_vidx is None:
        tri_vidx = np.arange(t_count * 3, dtype=np.int32).reshape(t_count, 3)
    tri_mesh, tri_prim, tri_vidx = (np.asarray(a) for a in
                                    (tri_mesh, tri_prim, tri_vidx))

    n = rays.count
    o, d, mn, mx = (_f64(getattr(rays, f))
                    for f in ("origin", "direction", "min_t", "max_t"))
    best_t = np.full((n,), np.inf, np.float64)
    best_idx = np.full((n,), -1, np.int64)
    best_u = np.zeros((n,), np.float64)
    best_v = np.zeros((n,), np.float64)
    for r0 in range(0, n, _RAY_BLOCK):
        r = slice(r0, r0 + _RAY_BLOCK)
        rows = np.arange(best_t[r].shape[0])
        for c0 in range(0, t_count, chunk):
            tris = tri_pos[None, c0:c0 + chunk]
            t, u, v, valid = _mt_intersect_f64(
                o[r, None, :], d[r, None, :], tris[:, :, 0], tris[:, :, 1],
                tris[:, :, 2], mn[r, None], mx[r, None])
            t = np.where(valid, t, np.inf)
            # Tie-break: strictly smaller t wins; equal t keeps the earlier
            # triangle (argmin picks the first minimum in the chunk).
            k = np.argmin(t, axis=1)
            tk = t[rows, k]
            improved = tk < best_t[r]
            best_idx[r] = np.where(improved, c0 + k, best_idx[r])
            best_u[r] = np.where(improved, u[rows, k], best_u[r])
            best_v[r] = np.where(improved, v[rows, k], best_v[r])
            best_t[r] = np.where(improved, tk, best_t[r])

    hit = best_idx >= 0
    safe = np.maximum(best_idx, 0)
    max_t = rays.max_t.detach().cpu().numpy().astype(np.float32)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32))

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    return Hits(
        hit=torch.from_numpy(hit),
        t=f32(np.where(hit, best_t.astype(np.float32), max_t)),
        u=f32(best_u), v=f32(best_v),
        mesh_index=i32(np.where(hit, tri_mesh[safe], -1)),
        triangle_index=i32(np.where(hit, tri_prim[safe], -1)),
        vertex_position=f32(tri_pos[safe]),
        vertex_index=i32(np.where(hit[:, None], tri_vidx[safe], -1)))
