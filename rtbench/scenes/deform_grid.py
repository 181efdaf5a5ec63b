"""Scene generator `deform_grid`: a wave over a regular grid in the XZ
plane, BASELINE.json's configuration 4 (a deforming mesh refit every
frame).  `make` gives the rest pose, the mesh at t = 0 (2 n² triangles,
one indexed mesh); `frame` moves a soup of it to time t, setting each
vertex's y to 0.4 sin(3x + 2t) cos(2.5z - 1.3t) with x and z kept, in
float32 as the vertices are."""
from __future__ import annotations

import numpy as np

from rtbench.scenes.shapes import grid_mesh


def height(x, z, t: float):
    """The wave's y at (x, z) and time t (float32 in, float32 out)."""
    return 0.4 * np.sin(3.0 * x + 2.0 * t) * np.cos(2.5 * z - 1.3 * t)


def make(n=96, extent=2.0):
    """-> (positions (V, 3) f32, indices (F, 3) i32) at t = 0."""
    verts, faces = grid_mesh(n, n, extent=extent)
    verts[:, 1] = height(verts[:, 0], verts[:, 2], 0.0)
    return verts, faces


def frame(soup: np.ndarray, t: float) -> np.ndarray:
    """The (T, 3, 3) f32 soup of the mesh at time t, from any of its
    frames' soups (x and z do not move)."""
    out = np.array(soup, np.float32)
    out[..., 1] = height(out[..., 0], out[..., 2], float(t))
    return out
