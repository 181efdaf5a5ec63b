"""Shapes the benchmark's scene generators are made of: frozen NumPy copies
of the program's procedural primitives (rtbench/tests holds the scenes
built from them equal to the program's own at the pinned seeds)."""
from __future__ import annotations

import numpy as np


def icosphere(subdivisions=3):
    """Unit icosphere: (V, 3) f32 vertices and (F, 3) i32 faces."""
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
    """Regular (nx x nz)-cell grid in the XZ plane: verts (V, 3), faces
    (F, 3)."""
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
