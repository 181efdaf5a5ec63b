"""The plain reference against a brute force written out ray by ray in
NumPy scalars on tiny soups, against the program's plain trace, and the
bfloat16 control against it."""
import numpy as np
import pytest
import torch

from rtbench import reference
from rtbench.scenes import blob

f32 = np.float32


def scalar_hit(o, d, tri, lo, hi):
    """rtk's watertight test for one ray and one triangle in float32
    scalars -> (hit, t, u, v)."""
    ad = np.abs(d)
    kz = 0 if ad[0] == ad.max() else (1 if ad[1] == ad.max() else 2)
    kx, ky = (kz + 1) % 3, (kz + 2) % 3
    sx, sy, sz = f32(-d[kx] / d[kz]), f32(-d[ky] / d[kz]), f32(f32(1) / d[kz])
    x, y, z = [], [], []
    for p in tri:
        r = (p - o).astype(f32)
        x.append(f32(r[kx] + f32(sx * r[kz])))
        y.append(f32(r[ky] + f32(sy * r[kz])))
        z.append(f32(sz * r[kz]))

    def edge(a, b, c, e):
        return f32(f32(a * b) - f32(c * e))

    u = edge(x[1], y[2], y[1], x[2])
    v = edge(x[2], y[0], y[2], x[0])
    w = edge(x[0], y[1], y[0], x[1])
    if u == 0 or v == 0 or w == 0:
        dbl = np.float64
        u = f32(dbl(x[1]) * dbl(y[2]) - dbl(y[1]) * dbl(x[2]))
        v = f32(dbl(x[2]) * dbl(y[0]) - dbl(y[2]) * dbl(x[0]))
        w = f32(dbl(x[0]) * dbl(y[1]) - dbl(y[0]) * dbl(x[1]))
    if (u < 0 or v < 0 or w < 0) and (u > 0 or v > 0 or w > 0):
        return False, 0.0, 0.0, 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        rcp = f32(f32(1) / f32(f32(u + v) + w))
        t = f32(f32(f32(f32(u * z[0]) + f32(v * z[1])) + f32(w * z[2])) * rcp)
    if not (t > lo and t < hi):
        return False, 0.0, 0.0, 0.0
    return True, t, f32(u * rcp), f32(v * rcp)


def scalar_closest(soup, o, d, lo, hi):
    best = (False, hi, 0.0, 0.0, -1)
    for i, tri in enumerate(soup):
        h, t, u, v = scalar_hit(o, d, tri, lo, best[1])
        if h:
            best = (True, t, u, v, i)
    return best


def tiny_soup():
    """A unit quad of two triangles sharing an edge, a tilted triangle
    in front of it and one behind, and a degenerate one."""
    return np.array([
        [[0, 0, 0], [1, 0, 0], [1, 1, 0]],
        [[0, 0, 0], [1, 1, 0], [0, 1, 0]],
        [[0.2, 0.2, 0.5], [0.8, 0.3, 0.4], [0.4, 0.9, 0.6]],
        [[-1, -1, -1], [2, -1, -1], [0.5, 2, -1]],
        [[0, 0, 0.3], [1, 1, 0.3], [2, 2, 0.3]],
    ], np.float32)


def rays(n, seed):
    g = np.random.default_rng(seed)
    o = np.concatenate([g.uniform(-0.2, 1.2, (n, 2)), np.full((n, 1), 2.0)],
                       1)
    d = np.concatenate([g.normal(0, 0.2, (n, 2)), -np.ones((n, 1))], 1)
    # Rays straight through the shared edge and a shared vertex.
    o[:4] = [[0.5, 0.5, 2], [0.25, 0.25, 2], [1, 1, 2], [0, 0, 2]]
    d[:4] = [[0, 0, -1]] * 4
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(f32), d.astype(f32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_matches_scalar_brute_force(seed):
    soup = tiny_soup()
    o, d = rays(64, seed)
    lo = np.zeros(64, f32)
    hi = np.full(64, 1e30, f32)
    got = reference.closest(*(torch.as_tensor(a) for a in (soup, o, d, lo,
                                                           hi)))
    for k in range(64):
        h, t, u, v, i = scalar_closest(soup, o[k], d[k], lo[k], hi[k])
        assert bool(got[0][k]) == h
        assert int(got[4][k]) == i
        if h:
            assert float(got[1][k]) == t
            assert float(got[2][k]) == u and float(got[3][k]) == v
    # The rays through the shared edge and vertex hit (watertight).
    assert got[0][:4].all()


def test_reference_matches_the_programs_plain_trace():
    import rtk_tpu_torch as rt

    v, f = blob.make(2)
    soup = torch.as_tensor(v[f])
    g = torch.Generator().manual_seed(4)
    n = 2048
    o = torch.tensor([[0.0, 0.3, 3.0]]).expand(n, 3).contiguous()
    d = torch.randn(n, 3, generator=g) * 0.35 + torch.tensor([0, -0.1, -1.])
    d = d / d.norm(dim=1, keepdim=True)
    lo, hi = torch.zeros(n), torch.full((n,), 1e30)
    tr = rt.Tracer(rt.build_scene((v, f), device="cpu"))
    h = tr.closest(rt.Rays(origin=o, direction=d, min_t=lo, max_t=hi))
    hit, t, u, vv, idx = reference.closest(soup, o, d, lo, hi)
    assert torch.equal(h.hit, hit) and torch.equal(h.t, t)
    same = h.triangle_index.long() == idx
    assert torch.equal(h.u[same], u[same]) and same[hit].float().mean() > 0.99


def test_control_departs_from_the_reference():
    v, f = blob.make(3)
    soup = torch.as_tensor(v[f])
    g = torch.Generator().manual_seed(5)
    n = 512
    o = torch.tensor([[0.0, 0.0, 3.0]]).expand(n, 3).contiguous()
    d = torch.randn(n, 3, generator=g) * 0.3 + torch.tensor([0, 0, -1.])
    d = d / d.norm(dim=1, keepdim=True)
    lo, hi = torch.zeros(n), torch.full((n,), 1e30)
    a = reference.closest(soup, o, d, lo, hi)
    b = reference.closest(soup, o, d, lo, hi, dtype=torch.bfloat16)
    both = a[0] & b[0]
    assert ((a[1] - b[1]).abs()[both] / a[1][both]).max() > 1e-3


def test_pairs_is_closest_on_the_named_triangle():
    v, f = blob.make(2)
    soup = torch.as_tensor(v[f])
    o = torch.tensor([[0.0, 0.0, 3.0]]).expand(256, 3).contiguous()
    d = torch.randn(256, 3, generator=torch.Generator().manual_seed(6))
    d = (d * 0.3 + torch.tensor([0, 0, -1.]))
    d = d / d.norm(dim=1, keepdim=True)
    lo, hi = torch.zeros(256), torch.full((256,), 1e30)
    hit, t, u, vv, idx = reference.closest(soup, o, d, lo, hi)
    ph, pt, pu, pv = reference.pairs(soup[idx.clamp_min(0)], o, d, lo, hi)
    assert ph[hit].all()
    assert torch.equal(pt[hit], t[hit]) and torch.equal(pu[hit], u[hit])
