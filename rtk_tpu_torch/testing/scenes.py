"""Procedural test scenes and camera-ray generation (NumPy generators).

The same deterministic generators as rtk_tpu.testing.scenes, so both
packages trace identical geometry: a Cornell box (~34 tris), a displaced
icosphere "blob" at bunny scale (81,920 tris at 6 subdivisions) and the
atrium (409,600 tris).  Camera rays come back as rtk_tpu_torch Rays on a
chosen device (the card unless the caller asks for another);
`on_device=True` computes them there with torch instead of in host
float64 (a 67M-ray host camera takes GBs of temporaries).
"""
from __future__ import annotations

import numpy as np
import torch

from rtk_tpu_torch.types import Rays


# ---------------------------------------------------------------------------
# Primitive builders (host-side NumPy)
# ---------------------------------------------------------------------------

def quad(a, b, c, d):
    """Two triangles for quad a-b-c-d (counter-clockwise)."""
    return np.array([[a, b, c], [a, c, d]], dtype=np.float32)


def box(lo, hi):
    """12 triangles for an axis-aligned box."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    p = lambda x, y, z: np.array([x, y, z], np.float32)
    tris = []
    tris.append(quad(p(x0, y0, z0), p(x1, y0, z0), p(x1, y1, z0), p(x0, y1, z0)))  # z-
    tris.append(quad(p(x0, y0, z1), p(x0, y1, z1), p(x1, y1, z1), p(x1, y0, z1)))  # z+
    tris.append(quad(p(x0, y0, z0), p(x0, y1, z0), p(x0, y1, z1), p(x0, y0, z1)))  # x-
    tris.append(quad(p(x1, y0, z0), p(x1, y0, z1), p(x1, y1, z1), p(x1, y1, z0)))  # x+
    tris.append(quad(p(x0, y0, z0), p(x0, y0, z1), p(x1, y0, z1), p(x1, y0, z0)))  # y-
    tris.append(quad(p(x0, y1, z0), p(x1, y1, z0), p(x1, y1, z1), p(x0, y1, z1)))  # y+
    return np.concatenate(tris, axis=0)


def transformed(tris, scale=1.0, rotate_y=0.0, translate=(0, 0, 0)):
    c, s = np.cos(rotate_y), np.sin(rotate_y)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    out = tris * np.float32(scale)
    out = out @ rot.T
    return out + np.asarray(translate, np.float32)


def icosphere(subdivisions=3):
    """Unit icosphere: (V, 3) vertices and (F, 3) faces."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdivisions):
        cache = {}
        vlist = list(verts)

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = (vlist[i] + vlist[j]) / 2.0
                m /= np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        new_faces = []
        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    return verts.astype(np.float32), faces.astype(np.int32)


def grid_mesh(nx, nz, height_fn=None, extent=1.0):
    """Regular (nx x nz)-cell grid in the XZ plane: verts (V,3), faces (F,3)."""
    xs = np.linspace(-extent, extent, nx + 1)
    zs = np.linspace(-extent, extent, nz + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    gy = height_fn(gx, gz) if height_fn else np.zeros_like(gx)
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    i, j = np.meshgrid(np.arange(nx), np.arange(nz), indexing="ij")
    v00 = (i * (nz + 1) + j).reshape(-1)
    v01 = v00 + 1
    v10 = v00 + (nz + 1)
    v11 = v10 + 1
    f0 = np.stack([v00, v10, v11], axis=1)
    f1 = np.stack([v00, v11, v01], axis=1)
    faces = np.concatenate([f0, f1], axis=0).astype(np.int32)
    return verts, faces


# ---------------------------------------------------------------------------
# Acceptance scenes (BASELINE.json configs)
# ---------------------------------------------------------------------------

def cornell_box():
    """~34-tri Cornell box: 5 walls + 2 boxes. Camera looks down -z? No:
    box interior spans [0,1]^3, opening towards +z; returns (verts-as-soup)."""
    tris = []
    p = lambda x, y, z: np.array([x, y, z], np.float32)
    # floor (y=0), ceiling (y=1), back wall (z=0), left (x=0), right (x=1)
    tris.append(quad(p(0, 0, 0), p(1, 0, 0), p(1, 0, 1), p(0, 0, 1)))
    tris.append(quad(p(0, 1, 0), p(0, 1, 1), p(1, 1, 1), p(1, 1, 0)))
    tris.append(quad(p(0, 0, 0), p(0, 1, 0), p(1, 1, 0), p(1, 0, 0)))
    tris.append(quad(p(0, 0, 0), p(0, 0, 1), p(0, 1, 1), p(0, 1, 0)))
    tris.append(quad(p(1, 0, 0), p(1, 1, 0), p(1, 1, 1), p(1, 0, 1)))
    # tall box and short box
    tall = transformed(box([-0.15, 0, -0.15], [0.15, 0.6, 0.15]),
                       rotate_y=0.3, translate=(0.35, 0.0, 0.35))
    short = transformed(box([-0.15, 0, -0.15], [0.15, 0.3, 0.15]),
                        rotate_y=-0.25, translate=(0.68, 0.0, 0.65))
    tris.append(tall)
    tris.append(short)
    return np.concatenate(tris, axis=0)


def blob(subdivisions=6, seed=0, displace=0.15):
    """Bunny-scale displaced icosphere. subdivisions=6 -> 81,920 tris;
    5 -> 20,480 tris (69k-class stand-in, BASELINE config 2)."""
    verts, faces = icosphere(subdivisions)
    rng = np.random.default_rng(seed)
    freqs = rng.normal(size=(4, 3)) * 3.0
    phases = rng.uniform(0, 2 * np.pi, size=4)
    amps = np.array([1.0, 0.5, 0.3, 0.2]) * displace
    r = np.ones(len(verts))
    for f, ph, a in zip(freqs, phases, amps):
        r += a * np.sin(verts @ f + ph)
    verts = verts * r[:, None]
    return verts.astype(np.float32)[faces].astype(np.float32), verts.astype(np.float32), faces


def atrium(columns=8, seed=0):
    """Sponza-scale procedural atrium (BASELINE config 3): a bumpy floor
    and ceiling of 2 x 32,768 triangles, a grid of columns x columns
    stretched icospheres (5,120 each) and four walls; 409,600 triangles at
    the defaults.  The same soup as rtk_tpu's, bit for bit."""
    parts = []
    # floor as a subdivided grid (lots of tris, like scanned geometry)
    rng = np.random.default_rng(seed)
    vf, ff = grid_mesh(128, 128,
                       lambda x, z: 0.02 * np.sin(9 * x) * np.cos(7 * z),
                       extent=10.0)
    parts.append(vf[ff])
    vc, fc = grid_mesh(
        128, 128, lambda x, z: 8.0 + 0.1 * np.sin(5 * x + 1) * np.cos(4 * z),
        extent=10.0)
    parts.append(vc[fc])
    # columns: displaced icospheres stretched vertically
    sphere_v, sphere_f = icosphere(4)
    for i in range(columns):
        for j in range(columns):
            x = -8.0 + 16.0 * i / max(columns - 1, 1)
            z = -8.0 + 16.0 * j / max(columns - 1, 1)
            s = 0.35 + 0.1 * rng.random()
            col = sphere_v * np.array([s, 4.0, s], np.float32)
            col = col + np.array([x, 4.0, z], np.float32)
            parts.append(col[sphere_f])
    # walls
    for sgn in (-1, 1):
        vw, fw = grid_mesh(64, 32, None, extent=1.0)
        wall = vw.copy()
        wall[:, 1] = (vw[:, 2] + 1.0) * 4.0
        wall[:, 2] = vw[:, 0] * 10.0
        wall[:, 0] = sgn * 10.0
        parts.append(wall[fw])
        wall2 = vw.copy()
        wall2[:, 1] = (vw[:, 2] + 1.0) * 4.0
        wall2[:, 0] = vw[:, 0] * 10.0
        wall2[:, 2] = sgn * 10.0
        parts.append(wall2[fw])
    return np.concatenate(parts, axis=0).astype(np.float32)


def deforming_grid(time: float, n=96):
    """Per-frame deformed grid (BASELINE config 4): a (T, 3, 3) soup of
    2*n*n triangles in a fixed topology and order, so refit applies.  Host
    NumPy, the same array as rtk_tpu's, bit for bit."""
    verts, faces = grid_mesh(n, n, extent=2.0)
    y = 0.4 * np.sin(3.0 * verts[:, 0] + 2.0 * time) * np.cos(
        2.5 * verts[:, 2] - 1.3 * time)
    v = verts.copy()
    v[:, 1] = y
    return v[faces]


# ---------------------------------------------------------------------------
# Cameras
# ---------------------------------------------------------------------------

def _pixel_zorder_perm(height, width):
    """Z-order (Morton) permutation of row-major pixel indices."""
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & 0x0000FFFF0000FFFF
        v = (v | (v << 8)) & 0x00FF00FF00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
        v = (v | (v << 2)) & 0x3333333333333333
        return (v | (v << 1)) & 0x5555555555555555

    return np.argsort(spread(xx.ravel()) | (spread(yy.ravel()) << 1))


def _compact_bits(v):
    """Inverse of the morton spread: gather the even bits of v (< 2^32)."""
    v = v & 0x55555555
    v = (v | (v >> 1)) & 0x33333333
    v = (v | (v >> 2)) & 0x0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF
    return (v | (v >> 8)) & 0x0000FFFF


def _camera_basis(eye, look_at, up):
    eye = np.asarray(eye, np.float32)
    look_at = np.asarray(look_at, np.float32)
    up = np.asarray(up, np.float32)
    fwd = look_at - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    cup = np.cross(right, fwd)
    return eye, fwd, right, cup


def _camera_rays_device(eye, look_at, up, fov_deg, width, height, max_t,
                        order, device):
    """camera_rays computed with torch on `device`.

    Directions agree with the host path up to float evaluation order
    (last bit); the Z-order layout is the exact same permutation for
    square power-of-two grids (dense morton codes: rank == code, so
    output k is pixel (compact(k), compact(k >> 1)))."""
    if order == "morton" and (width != height or width & (width - 1) != 0):
        raise ValueError("device camera_rays: morton order needs a "
                         "square power-of-two grid")
    if order not in ("raster", "morton"):
        raise ValueError(f"unknown ray order {order!r}")
    eye, fwd, right, cup = (torch.as_tensor(a, device=device)
                            for a in _camera_basis(eye, look_at, up))
    n = width * height
    k = torch.arange(n, dtype=torch.int64, device=device)
    if order == "morton":
        xx, yy = _compact_bits(k), _compact_bits(k >> 1)
    else:
        xx, yy = k % width, k // width
    del k
    tan = float(np.float32(np.tan(np.radians(fov_deg) * 0.5)))
    xs = ((-1.0 + 2.0 * xx.to(torch.float32) / (width - 1))
          * tan * (width / height))
    ys = (1.0 - 2.0 * yy.to(torch.float32) / (height - 1)) * tan
    del xx, yy
    dirs = fwd[None] + xs[:, None] * right[None] + ys[:, None] * cup[None]
    del xs, ys
    dirs /= torch.linalg.vector_norm(dirs, dim=1, keepdim=True)
    return Rays(
        origin=eye[None].expand(n, 3),
        direction=dirs,
        min_t=torch.zeros((n,), dtype=torch.float32, device=device),
        max_t=torch.full((n,), float(np.float32(max_t)),
                         dtype=torch.float32, device=device))


def camera_rays(eye, look_at, up, fov_deg, width, height, max_t=1e30,
                order="raster", device="cuda", on_device=False):
    """Pinhole primary rays on `device`.  Returns Rays.

    order="raster": row-major pixel order.  order="morton": Z-order pixel
    tiles, so consecutive rays form square screen tiles.

    on_device=True computes the rays with torch on `device` (no host
    megaray buffers); directions agree with the host path to float
    evaluation order, and the morton layout is the identical permutation
    for square power-of-two grids.
    """
    if on_device:
        return _camera_rays_device(eye, look_at, up, fov_deg, width,
                                   height, max_t, order, device)
    eye, fwd, right, cup = _camera_basis(eye, look_at, up)
    tan = np.tan(np.radians(fov_deg) * 0.5)
    ys, xs = np.meshgrid(
        np.linspace(1, -1, height) * tan,
        np.linspace(-1, 1, width) * tan * (width / height),
        indexing="ij",
    )
    dirs = fwd[None, None] + xs[..., None] * right + ys[..., None] * cup
    dirs = dirs.reshape(-1, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    if order == "morton":
        dirs = dirs[_pixel_zorder_perm(height, width)]
    elif order != "raster":
        raise ValueError(f"unknown ray order {order!r}")
    n = dirs.shape[0]
    origins = np.broadcast_to(eye, (n, 3)).copy()
    return Rays.make(origins, dirs.astype(np.float32),
                     min_t=np.zeros(n, np.float32),
                     max_t=np.full(n, max_t, np.float32), device=device)


def cornell_camera(width=256, height=256, device="cuda"):
    return camera_rays(eye=(0.5, 0.5, 2.2), look_at=(0.5, 0.5, 0.0),
                       up=(0, 1, 0), fov_deg=40.0, width=width, height=height,
                       device=device)
