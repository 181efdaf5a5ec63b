"""Traffic kind "bounce": one diffuse bounce off the scene's surfaces.
Origins are points drawn by area over the soup's triangles (uniform
within each triangle; a batch's `source` holds each ray's triangle),
pushed `eps` along the geometric normal turned to face the batch's eye
(eyes[b % len(eyes)]: the side a camera there sees); directions are
cosine-distributed about that normal; min_t is `eps`.  Rays come in the
order drawn, so neighbours share nothing.  Parameters: rays, batches,
eps, max_t, eyes."""
from __future__ import annotations

import math

import torch

from rtbench.traffic.generate import BATCH_BASE, device_generator


def make(t: dict, seed: int, soup: torch.Tensor, device):
    """The batches of bounce traffic `t` for `seed` over soup (T, 3, 3)."""
    n = int(t["rays"])
    eps = float(t["eps"])
    v0, v1, v2 = soup[:, 0].double(), soup[:, 1].double(), soup[:, 2].double()
    cross = torch.linalg.cross(v1 - v0, v2 - v0)
    area = torch.linalg.vector_norm(cross, dim=1)
    cdf = torch.cumsum(area, 0)
    normal = (cross / area.clamp_min(1e-300)[:, None])
    out = []
    for b in range(int(t["batches"])):
        g = device_generator(seed, BATCH_BASE + b, device)
        r = torch.rand((n, 5), generator=g, device=device,
                       dtype=torch.float64)
        tri = torch.searchsorted(cdf, r[:, 0] * cdf[-1], right=True)
        tri = tri.clamp_max(soup.shape[0] - 1)
        s = r[:, 1].sqrt()
        a, bb = 1.0 - s, s * (1.0 - r[:, 2])
        p = (a[:, None] * v0[tri] + bb[:, None] * v1[tri]
             + (1.0 - a - bb)[:, None] * v2[tri])
        eye = torch.tensor(t["eyes"][b % len(t["eyes"])], dtype=torch.float64,
                           device=device)
        nrm = normal[tri]
        nrm = torch.where(((eye - p) * nrm).sum(1, keepdim=True) < 0, -nrm,
                          nrm)
        # An orthonormal basis about the normal (Duff et al. 2017).
        sign = torch.where(nrm[:, 2] >= 0, 1.0, -1.0)
        aa = -1.0 / (sign + nrm[:, 2])
        bxy = nrm[:, 0] * nrm[:, 1] * aa
        tx = torch.stack([1.0 + sign * nrm[:, 0] ** 2 * aa, sign * bxy,
                          -sign * nrm[:, 0]], 1)
        ty = torch.stack([bxy, sign + nrm[:, 1] ** 2 * aa, -nrm[:, 1]], 1)
        rad, phi = r[:, 3].sqrt(), 2.0 * math.pi * r[:, 4]
        d = (tx * (rad * phi.cos())[:, None] + ty * (rad * phi.sin())[:, None]
             + nrm * (1.0 - r[:, 3]).clamp_min(0).sqrt()[:, None])
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        out.append(dict(
            origin=(p + eps * nrm).float(), direction=d.float(), source=tri,
            min_t=torch.full((n,), eps, dtype=torch.float32, device=device),
            max_t=torch.full((n,), float(t["max_t"]), dtype=torch.float32,
                             device=device)))
    return out
