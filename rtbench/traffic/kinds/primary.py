"""Traffic kind "primary": pinhole camera rays over a side x side image in
Morton (Z-order) pixel order, so consecutive rays form square screen
tiles.  Batch b looks from views[b % len(views)] ({eye, look_at, up,
fov_deg}), its eye turned about look_at by an angle drawn up to
`orbit_deg` about an axis drawn at random, and its pixels shifted by a
sub-pixel offset drawn in [-0.5, 0.5).  Parameters: side (a power of two),
batches, orbit_deg, max_t, views."""
from __future__ import annotations

import math

import numpy as np
import torch

from rtbench.traffic.generate import POSES, rng


def _compact(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x55555555
    v = (v | (v >> 1)) & 0x33333333
    v = (v | (v >> 2)) & 0x0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF
    return (v | (v >> 8)) & 0x0000FFFF


def _rotate(p, axis, angle):
    """Rodrigues' rotation of p about a unit axis (host float64)."""
    c, s = math.cos(angle), math.sin(angle)
    return p * c + np.cross(axis, p) * s + axis * np.dot(axis, p) * (1 - c)


def make(t: dict, seed: int, soup, device):
    """The batches of primary traffic `t` for `seed` (soup unused)."""
    side = int(t["side"])
    if side & (side - 1):
        raise ValueError("primary traffic: side must be a power of two")
    n = side * side
    host = rng(seed, POSES)
    k = torch.arange(n, dtype=torch.int64, device=device)
    px = _compact(k).to(torch.float32)
    py = _compact(k >> 1).to(torch.float32)
    del k
    out = []
    for b in range(int(t["batches"])):
        view = t["views"][b % len(t["views"])]
        eye = np.asarray(view["eye"], np.float64)
        at = np.asarray(view["look_at"], np.float64)
        axis = host.normal(size=3)
        axis /= np.linalg.norm(axis)
        angle = math.radians(float(t.get("orbit_deg", 0.0))) * host.random()
        eye = at + _rotate(eye - at, axis, angle)
        jx, jy = host.random(2) - 0.5
        fwd = at - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(view["up"], np.float64))
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        tan = math.tan(math.radians(float(view["fov_deg"])) * 0.5)
        xs = (-1.0 + 2.0 * (px + float(0.5 + jx)) / side) * tan
        ys = (1.0 - 2.0 * (py + float(0.5 + jy)) / side) * tan
        basis = torch.tensor(np.stack([fwd, right, up]), dtype=torch.float32,
                             device=device)
        d = basis[0] + xs[:, None] * basis[1] + ys[:, None] * basis[2]
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        o = torch.tensor(eye, dtype=torch.float32,
                         device=device).expand(n, 3).contiguous()
        out.append(dict(
            origin=o, direction=d,
            min_t=torch.zeros(n, dtype=torch.float32, device=device),
            max_t=torch.full((n,), float(t["max_t"]), dtype=torch.float32,
                             device=device)))
    return out
