"""Scene generator `atrium`: a procedural hall of 409,600 triangles
(floor, ceiling, 64 columns, four walls), one indexed mesh whose triangle
k is soup row k."""
from __future__ import annotations

import numpy as np

from rtbench.scenes.shapes import grid_mesh, icosphere


def atrium_soup(columns=8, seed=0):
    """The atrium as a (T, 3, 3) f32 soup: a bumpy floor and
    ceiling of 2 x 32,768 triangles, columns x columns stretched
    icospheres of 5,120 triangles each and four walls; 409,600 triangles
    at the defaults."""
    parts = []
    rng = np.random.default_rng(seed)
    vf, ff = grid_mesh(128, 128,
                       lambda x, z: 0.02 * np.sin(9 * x) * np.cos(7 * z),
                       extent=10.0)
    parts.append(vf[ff])
    vc, fc = grid_mesh(
        128, 128, lambda x, z: 8.0 + 0.1 * np.sin(5 * x + 1) * np.cos(4 * z),
        extent=10.0)
    parts.append(vc[fc])
    sphere_v, sphere_f = icosphere(4)
    for i in range(columns):
        for j in range(columns):
            x = -8.0 + 16.0 * i / max(columns - 1, 1)
            z = -8.0 + 16.0 * j / max(columns - 1, 1)
            s = 0.35 + 0.1 * rng.random()
            col = sphere_v * np.array([s, 4.0, s], np.float32)
            col = col + np.array([x, 4.0, z], np.float32)
            parts.append(col[sphere_f])
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


def make(columns=8, seed=0):
    """-> (positions (3T, 3) f32, indices (T, 3) i32)."""
    soup = atrium_soup(columns, seed)
    n = soup.shape[0]
    return soup.reshape(-1, 3), np.arange(3 * n, dtype=np.int32).reshape(n, 3)
