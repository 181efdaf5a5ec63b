"""Scene generator `blob`: a displaced icosphere (81,920
triangles at 6 subdivisions), one indexed mesh."""
from __future__ import annotations

import numpy as np

from rtbench.scenes.shapes import icosphere


def make(subdivisions=6, seed=0, displace=0.15):
    """-> (positions (V, 3) f32, indices (F, 3) i32)."""
    verts, faces = icosphere(subdivisions)
    rng = np.random.default_rng(seed)
    freqs = rng.normal(size=(4, 3)) * 3.0
    phases = rng.uniform(0, 2 * np.pi, size=4)
    amps = np.array([1.0, 0.5, 0.3, 0.2]) * displace
    r = np.ones(len(verts))
    for f, ph, a in zip(freqs, phases, amps):
        r += a * np.sin(verts @ f + ph)
    verts = verts * r[:, None]
    return verts.astype(np.float32), faces.astype(np.int32)


