"""Traffic kind "path_primary": the primary kind's pinhole batches
(primary.py: side, batches, orbit_deg, max_t, views), each with the
draws of a path tracer's bounces: `uniforms`, a (bounces, N, 2) float32
tensor in [0, 1) drawn on the device from a stream of the seed of its own,
whose [k, i] are the two draws of bounce k of the path that starts as ray
i.  Parameters: primary's, and bounces."""
from __future__ import annotations

from pathlib import Path

import torch

from rtbench.loader import load_module
from rtbench.traffic.generate import device_generator

UNIFORMS = 3000  # the uniforms of batch b: the seed's stream UNIFORMS + b

primary = load_module(Path(__file__).with_name("primary.py"))


def make(t: dict, seed: int, soup, device):
    """The batches of path_primary traffic `t` for `seed` (soup unused)."""
    out = primary.make(t, seed, soup, device)
    for b, x in enumerate(out):
        g = device_generator(seed, UNIFORMS + b, device)
        x["uniforms"] = torch.rand(
            (int(t["bounces"]), x["origin"].shape[0], 2), generator=g,
            device=device, dtype=torch.float32)
    return out
