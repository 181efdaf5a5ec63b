"""Bounce-ray helpers of the wavefront path tracer (rtk_tpu.models.path).

Ported so far: the geometric normal of a hit and cosine-weighted
hemisphere sampling, which turn a batch of primary hits into the diffuse
bounce batch of BASELINE config 3 (the atrium).  The render loops
(render_path, render_direct, render_ao) and the wavefront compaction are
still to port.
"""
from __future__ import annotations

import math

import torch


def geometric_normal(hits, direction: torch.Tensor) -> torch.Tensor:
    """Unit geometric normal of each hit triangle, flipped to face the
    incoming ray. (N, 3)."""
    v = hits.vertex_position
    n = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n = n / torch.linalg.vector_norm(n, dim=1, keepdim=True).clamp_min(1e-20)
    flip = (n * direction).sum(dim=1, keepdim=True) > 0
    return torch.where(flip, -n, n)


def cosine_sample(generator: torch.Generator | None, normal: torch.Tensor,
                  u1: torch.Tensor | None = None,
                  u2: torch.Tensor | None = None) -> torch.Tensor:
    """Cosine-weighted hemisphere directions around unit normals. (N, 3).

    The two uniforms a direction are drawn from `generator` (a
    torch.Generator on the normals' device; None: torch's default), or
    taken as given: u1, u2 (N,) in [0, 1).  rtk_tpu draws them from a JAX
    key; the same uniforms give the same directions."""
    n = normal.shape[0]
    if u1 is None or u2 is None:
        u1, u2 = torch.rand((2, n), generator=generator,
                            device=normal.device, dtype=torch.float32)
    u1 = torch.as_tensor(u1, dtype=torch.float32, device=normal.device)
    u2 = torch.as_tensor(u2, dtype=torch.float32, device=normal.device)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    # Orthonormal basis around the normal (branchless, Frisvad style).
    nx, ny, nz = normal.unbind(dim=1)
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t1 = torch.stack([1.0 + sign * nx ** 2 * a, sign * b, -sign * nx], dim=1)
    t2 = torch.stack([b, sign + ny ** 2 * a, -ny], dim=1)
    return (x[:, None] * t1 + y[:, None] * t2
            + z[:, None] * normal).to(torch.float32)
