"""rtk_tpu_torch.ops.intersect against rtk_tpu.ops.intersect on the same
seeded inputs, and the intersector cases of tests/test_intersect.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtk_tpu.ops import intersect as jx
from rtk_tpu_torch.ops import intersect as tx
from rtk_tpu_torch.testing.scenes import icosphere

torch.set_num_threads(2)

TRI = [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]


def _single(origin, direction, tri, min_t=0.0, cur_t=1e30):
    o = torch.tensor([origin], dtype=torch.float32)
    d = torch.tensor([direction], dtype=torch.float32)
    t, u, v, ok = tx.intersect_triangles(
        o, tx.ray_shear(d), torch.tensor(tri, dtype=torch.float32).reshape(
            1, 1, 3, 3),
        torch.tensor([min_t], dtype=torch.float32),
        torch.tensor([cur_t], dtype=torch.float32))
    return float(t[0, 0]), float(u[0, 0]), float(v[0, 0]), bool(ok[0, 0])


def test_ray_shear_matches_reference():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d[:40] = np.round(d[:40])  # exact |d| ties exercise the x, y, z rule
    d[40:48] = [1.0, -1.0, 1.0]
    want = jx.ray_shear(jnp.asarray(d))
    got = tx.ray_shear(torch.from_numpy(d))
    for f in ("kx", "ky", "kz"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    for f in ("sx", "sy", "sz"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


def test_intersect_triangles_matches_reference():
    """Random rays against random triangles: same valid mask, t within
    1e-5 relative, u/v within 1e-5 (the f64 and double-word exact paths
    may differ in the last bits)."""
    rng = np.random.default_rng(1)
    n, k = 256, 24
    o = (rng.normal(size=(n, 3)) * 2.0).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    tri = rng.normal(size=(n, k, 3, 3)).astype(np.float32)
    mint = np.zeros(n, np.float32)
    maxt = np.full(n, 1e30, np.float32)
    wt, wu, wv, wok = map(np.asarray, jx.intersect_triangles(
        jnp.asarray(o), jx.ray_shear(jnp.asarray(d)), jnp.asarray(tri),
        jnp.asarray(mint), jnp.asarray(maxt)))
    gt, gu, gv, gok = (a.numpy() for a in tx.intersect_triangles(
        torch.from_numpy(o), tx.ray_shear(torch.from_numpy(d)),
        torch.from_numpy(tri), torch.from_numpy(mint),
        torch.from_numpy(maxt)))
    np.testing.assert_array_equal(gok, wok)
    assert wok.sum() > 50  # enough hits to compare
    np.testing.assert_allclose(gt[wok], wt[wok], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gu[wok], wu[wok], atol=1e-5)
    np.testing.assert_allclose(gv[wok], wv[wok], atol=1e-5)


def test_simple_hit():
    t, u, v, ok = _single([0.2, 0.2, 1.0], [0.0, 0.0, -1.0], TRI)
    assert ok and abs(t - 1.0) < 1e-6
    assert abs(v - 0.2) < 1e-5 and abs((1 - u - v) - 0.2) < 1e-5


def test_t_window_open_interval():
    # t == max_t and t == min_t are rejected (strict, rtk.c:354).
    assert not _single([0.2, 0.2, 1.0], [0.0, 0.0, -1.0], TRI, cur_t=1.0)[3]
    assert not _single([0.2, 0.2, 1.0], [0.0, 0.0, -1.0], TRI, min_t=1.0)[3]
    assert _single([0.2, 0.2, 1.0], [0.0, 0.0, -1.0], TRI, min_t=0.999,
                   cur_t=1.001)[3]


@pytest.mark.parametrize("origin", [[0.5, 0.0, 1.0], [0.0, 0.0, 1.0],
                                    [0.5, 0.5, 1.0]],
                         ids=["edge", "vertex", "diagonal"])
def test_edge_and_vertex_hits(origin):
    # Rays exactly through an edge or a vertex must hit (zeros allowed).
    assert _single(origin, [0.0, 0.0, -1.0], TRI)[3]


def test_watertight_closed_mesh_no_leaks():
    """Rays from inside a closed icosphere aimed at every edge midpoint,
    random edge points and vertices hit, against the whole triangle set,
    and the valid masks equal the reference's."""
    verts, faces = icosphere(2)  # 320 tris, closed
    tris = verts[faces].astype(np.float32)
    rng = np.random.default_rng(7)
    edges = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    lam = rng.uniform(0.0, 1.0, size=(edges.shape[0], 1)).astype(np.float32)
    edge_pts = verts[edges[:, 0]] * (1 - lam) + verts[edges[:, 1]] * lam
    mids = (verts[edges[:, 0]] + verts[edges[:, 1]]) * 0.5
    d = np.concatenate([mids, edge_pts, verts], axis=0).astype(np.float32)
    n = d.shape[0]
    o = np.zeros_like(d)
    tri_b = np.broadcast_to(tris[None], (n,) + tris.shape)
    mint = np.zeros(n, np.float32)
    maxt = np.full(n, 1e30, np.float32)
    *_, gok = tx.intersect_triangles(
        torch.from_numpy(o), tx.ray_shear(torch.from_numpy(d)),
        torch.from_numpy(np.ascontiguousarray(tri_b)),
        torch.from_numpy(mint), torch.from_numpy(maxt))
    gok = gok.numpy()
    assert gok.any(axis=1).all(), f"{(~gok.any(axis=1)).sum()} leaked rays"
    *_, wok = jx.intersect_triangles(
        jnp.asarray(o), jx.ray_shear(jnp.asarray(d)), jnp.asarray(tri_b),
        jnp.asarray(mint), jnp.asarray(maxt))
    np.testing.assert_array_equal(gok, np.asarray(wok))


def test_exact_fallback_is_f64():
    """w = x0*y1 - y0*x1 rounds to exactly 0 in f32 but is 2^-24: the
    fallback recomputes it in f64 (rtk.c:294-336)."""
    one = lambda x: torch.tensor([x], dtype=torch.float32)  # noqa: E731
    x0, y1 = one(1.0 + 2 ** -12), one(1.0 + 2 ** -12)
    y0, x1 = one(1.0 + 2 ** -11), one(1.0)
    x2 = y2 = one(0.0)
    _, _, w = tx.watertight_uvw(x0, y0, x1, y1, x2, y2, watertight=False)
    assert float(w[0]) == 0.0
    _, _, w = tx.watertight_uvw(x0, y0, x1, y1, x2, y2)
    assert float(w[0]) == 2.0 ** -24


def test_degenerate_triangle_misses():
    assert not _single([0.2, 0.2, 1.0], [0.0, 0.0, -1.0],
                       [[0, 0, 0], [0, 0, 0], [0, 0, 0]])[3]


def test_shear_axis_priority():
    # Ties on |dir| components pick x, then y, then z (rtk.c:553).
    s = tx.ray_shear(torch.tensor([[1.0, 1.0, 1.0]]))
    assert int(s.kz[0]) == 0
    s = tx.ray_shear(torch.tensor([[0.5, 1.0, 1.0]]))
    assert int(s.kz[0]) == 1


def test_slab_matches_reference():
    rng = np.random.default_rng(3)
    n = 128
    lo = rng.normal(size=(n, 8, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 1, size=(n, 8, 3)).astype(np.float32)
    o = (rng.normal(size=(n, 3)) * 2).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:16, 0] = 0.0  # axis-parallel rays
    mint = np.zeros(n, np.float32)
    cur = np.full(n, 1e30, np.float32)
    wt, wh = jx.slab_test(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(o),
                          jx.rcp_direction(jnp.asarray(d)),
                          jnp.asarray(mint), jnp.asarray(cur))
    gt, gh = tx.slab_test(torch.from_numpy(lo), torch.from_numpy(hi),
                          torch.from_numpy(o),
                          tx.rcp_direction(torch.from_numpy(d)),
                          torch.from_numpy(mint), torch.from_numpy(cur))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


def test_inverted_bounds_always_miss():
    # Empty wide-node slots carry inverted bounds (+1/-1), rtk.c:1612-1620.
    cmin = torch.ones((1, 1, 3))
    cmax = -torch.ones((1, 1, 3))
    for d in ([0, 0, 1], [1, 1, 1], [0, 1, 0]):
        rcp = tx.rcp_direction(torch.tensor([d], dtype=torch.float32))
        _, hit = tx.slab_test(cmin, cmax, torch.zeros((1, 3)), rcp,
                              torch.tensor([0.0]), torch.tensor([1e30]))
        assert not bool(hit[0, 0])
