"""The traffic generator: ray batches from a traffic file and a seed.

A traffic file (rtbench/traffic/<name>.json) names its `kind` and the
parameters of that kind; the kind is a file of its own,
rtbench/traffic/kinds/<kind>.py, whose `make(traffic, seed, soup,
device)` returns the `batches` batches on the device, each a dict of
origin (N, 3), direction (N, 3), min_t (N,) and max_t (N,) float32
tensors.  The same seed gives the same batches.  The seed draws where
each batch looks and which rays it holds; the traffic file fixes how many
rays and how many batches, and the views whose neighbourhood the poses
are drawn from, so every seed asks for the same amount of work.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from rtbench.loader import load_module

KINDS = Path(__file__).resolve().parent / "kinds"
# Streams drawn from one seed (the second word of the entropy).
POSES, BATCH_BASE = 1, 1000


def rng(seed: int, stream: int) -> np.random.Generator:
    """The host generator of one stream of a seed (any whole number)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(rng(seed, stream).integers(0, 1 << 63)))
    return g


def make(traffic: dict, seed: int, soup: torch.Tensor, device,
         kinds: Path = KINDS):
    """The batches of `traffic` for `seed` on `device`; soup (T, 3, 3) is
    the scene's triangles on that device (the bounce kind samples them);
    kinds: the folder of the kinds' files."""
    kind = traffic["kind"]
    if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", kind):
        raise ValueError(f"bad traffic kind {kind!r}")
    path = Path(kinds) / f"{kind}.py"
    if not path.is_file():
        raise ValueError(f"unknown traffic kind {kind!r}: no {path.name} "
                         f"under rtbench/traffic/kinds")
    return load_module(path).make(traffic, seed, soup, device)
