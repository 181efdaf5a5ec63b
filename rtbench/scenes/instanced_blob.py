"""Scene generator `instanced_blob`: BASELINE.json's configuration 5 as
bench.py::config_instanced places it.  One BLAS, the `blob` generator's
mesh, is instanced side^3 times on a lattice of the given spacing: the
instance i at cell (i mod side, i / side mod side, i / side^2) takes a
uniform scale 0.35 + 0.15 u and the lattice point times the spacing plus
a jitter 0.2 u on each axis, the draws from default_rng(layout_seed) in
bench.py's order (the scale, then the three jitters, instance by
instance).  `instances` gives the BLAS and the (I, 3, 4) world-from-object
affines; `make` the world soup they make, every instance's copy of the
mesh through its affine in float32, as one indexed mesh."""
from __future__ import annotations

import numpy as np

from rtbench.scenes import blob


def instances(subdivisions=6, seed=0, displace=0.15, side=5, spacing=1.1,
              layout_seed=7):
    """-> (positions (V, 3) f32, indices (F, 3) i32 of the BLAS,
    transforms (side^3, 3, 4) f32)."""
    positions, indices = blob.make(subdivisions, seed, displace)
    n = side ** 3
    tf = np.zeros((n, 3, 4), np.float32)
    rng = np.random.default_rng(layout_seed)
    for i in range(n):
        cell = np.array([i % side, (i // side) % side, i // (side * side)],
                        np.float32)
        scale = 0.35 + 0.15 * rng.random()
        tf[i, :, :3] = np.eye(3, dtype=np.float32) * scale
        tf[i, :, 3] = cell * spacing + rng.random(3).astype(np.float32) * 0.2
    return positions, indices, tf


def world(positions, transforms) -> np.ndarray:
    """(I, V, 3) f32: the BLAS's vertices through each affine."""
    lin = transforms[:, :, :3]
    return (np.einsum("iab,vb->iva", lin, positions)
            + transforms[:, None, :, 3]).astype(np.float32)


def make(**args):
    """-> (positions (I V, 3) f32, indices (I F, 3) i32): the world soup."""
    positions, indices, tf = instances(**args)
    v = len(positions)
    offsets = (np.arange(len(tf), dtype=np.int64) * v)[:, None, None]
    return (world(positions, tf).reshape(-1, 3),
            (indices[None].astype(np.int64) + offsets).reshape(-1, 3)
            .astype(np.int32))
