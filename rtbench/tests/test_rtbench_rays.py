"""The traffic generator: the same seed gives the same batches, another
seed other rays of the same sizes; the rays are well formed."""
import json
from pathlib import Path

import pytest
import torch

from rtbench.scenes import blob
from rtbench.traffic import generate
from rtbench.tests import tiny

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
SOUP = torch.as_tensor((lambda v, f: v[f])(*blob.make(2)))


def batches(name, seed):
    return generate.make(tiny.TRAFFIC[name], seed, SOUP, "cpu")


@pytest.mark.parametrize("name", sorted(tiny.TRAFFIC))
def test_same_seed_same_rays(name):
    a, b = batches(name, 2**31 + 5), batches(name, 2**31 + 5)
    c = batches(name, 2**31 + 6)
    assert len(a) == len(c) == tiny.TRAFFIC[name]["batches"]
    for x, y, z in zip(a, b, c):
        for k in ("origin", "direction", "min_t", "max_t"):
            assert torch.equal(x[k], y[k])
            assert x[k].shape == z[k].shape and x[k].dtype == torch.float32
        assert not torch.equal(x["direction"], z["direction"])


@pytest.mark.parametrize("name", sorted(tiny.TRAFFIC))
def test_rays_are_well_formed(name):
    for x in batches(name, 11):
        n = x["origin"].shape[0]
        norm = torch.linalg.vector_norm(x["direction"], dim=1)
        assert torch.allclose(norm, torch.ones(n), atol=1e-5)
        assert (x["min_t"] < x["max_t"]).all()
        assert torch.isfinite(x["origin"]).all()


def test_bounce_leaves_the_surface_on_the_eyes_side():
    t = tiny.TRAFFIC["tiny-bounce"]
    for b, x in enumerate(batches("tiny-bounce", 5)):
        # Every origin lies eps off its triangle's plane on the eye's side,
        # inside the triangle's prism, and every direction leaves that side.
        eye = torch.tensor(t["eyes"][b % len(t["eyes"])], dtype=torch.float32)
        v0, v1, v2 = (SOUP[x["source"], k] for k in range(3))
        n = torch.linalg.cross(v1 - v0, v2 - v0)
        n = n / torch.linalg.vector_norm(n, dim=1, keepdim=True)
        side = torch.sign(((eye - v0) * n).sum(-1))
        d = ((x["origin"] - v0) * n).sum(-1) * side
        assert (d - t["eps"]).abs().max() < 1e-5
        assert ((x["direction"] * n).sum(-1) * side > 0).all()
        for a, c in ((v0, v1), (v1, v2), (v2, v0)):
            inward = (torch.linalg.cross(c - a, x["origin"] - a) * n).sum(-1)
            assert (inward > -1e-5).all()


def test_primary_morton_order():
    x = batches("tiny-orbit", 3)[0]
    side = tiny.TRAFFIC["tiny-orbit"]["side"]
    # Consecutive groups of four rays are 2 x 2 pixel tiles: their
    # directions lie closer together than rays a tile row apart.
    d = x["direction"].reshape(-1, 4, 3)
    inside = (d[:, 1:] - d[:, :1]).norm(dim=-1).max()
    assert inside < 2.5 * (2 * 0.414 / side)
    assert (x["origin"] == x["origin"][0]).all()


@pytest.mark.parametrize("path", sorted(TRAFFIC.glob("*.json")),
                         ids=lambda p: p.stem)
def test_benchmark_traffic_files(path):
    t = json.loads(path.read_text())
    assert t["kind"] in ("primary", "bounce")
    assert set(t["check"]["limits"]) == {"t_gap", "record_gap",
                                         "record_bad_share"}
    assert t["batches"] >= 2
